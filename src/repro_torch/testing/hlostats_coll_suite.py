"""hlostats collective check on 4 ranks: the twin of
``repro.testing.hlostats_coll_suite``.

T = 10 all-reduces of a (256, 256) f32 operand, each after a matrix
product, through the GAS engine's all-reduce inside a Python loop of one
``Context.spmd`` node program.  The op-stream counter must see each
all-reduce once, with one rank's operand bytes: T·M·M·4 within 5%, as
the reference's trip-count-aware HLO count is held.

Run:  PYTHONPATH=src python -m repro_torch.testing.hlostats_coll_suite [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from repro_torch.compat import resolve_device
from repro_torch.core import gasnet
from repro_torch.core.gasnet import P
from repro_torch.launch import hlostats

N, M, T = 4, 256, 10


def run(device) -> hlostats.HloStats:
    """The counted program's stats, its collective bytes checked."""
    ctx = gasnet.Context(N, backend="xla", device=device)
    x = torch.zeros((M, M), dtype=torch.float32, device=device)
    ws = torch.zeros((T, M, M), dtype=torch.float32, device=device)

    def prog(node, c, w):
        for i in range(T):
            c = node.engine.all_reduce(c @ w[i])
        return c

    st = hlostats.analyze(lambda: ctx.spmd(prog, x, ws, in_specs=(P(), P()),
                                           out_specs=P()))
    expect = T * M * M * 4  # T all-reduces of (M, M) f32 operands
    assert abs(st.collective_bytes - expect) / expect < 0.05, (
        st.collective_bytes, expect)
    per = st.collective_per_type["all-reduce"]
    assert abs(per - expect) / expect < 0.05, (per, expect)
    assert st.collective_counts["all-reduce"] == T
    return st


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda, cpu, or meta (shapes only)")
    args = ap.parse_args(argv)
    dev = (torch.device("meta") if args.device == "meta"
           else resolve_device(args.device))
    run(dev)
    print("HLOSTATS_COLL_PASS")


if __name__ == "__main__":
    main()
