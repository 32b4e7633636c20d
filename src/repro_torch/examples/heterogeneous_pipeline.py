"""The paper's signature demo (§II/§IV) on the port: software and hardware
nodes cooperating transparently through one API.

Act 1 — *develop in software*: a producer/consumer pipeline where every
stage communicates with one-sided puts through the software ("xla")
engine.  Act 2 — *migrate to hardware*: the identical program runs with
the GAScore engine (the hand-written CUDA copy kernels), and the results
match.  Act 2b — a heterogeneous node map mixes both in one job.  Act 3 —
a serving-shaped use: a "prefill node" hands a KV cache to a "decode
node" with a single one-sided GAScore put at a sender-chosen offset.
Acts 1, 2, 2b and 3 of the reference's ``examples/heterogeneous_pipeline.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.heterogeneous_pipeline
      [--backend gascore] [--n-nodes 4] [--device cpu]

``--backend`` names the engine of act 2 (the migration target).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import gasnet, transport
from repro_torch.core.gasnet import P
from repro_torch.launch.mesh import node_backends


def pipeline_program(node, inbox, x):
    """A 3-stage pipeline over the ring: each node transforms what the
    previous node put into its inbox, then puts the result onward."""
    N = node.n_nodes
    work = node.local(x)  # stage 0: produce
    for _hop in range(N - 1):
        # transform then one-sided put to the right neighbor's inbox
        work = torch.tanh(work) * 1.1
        inbox = node.put(inbox, work, to=gasnet.Shift(1), index=0)
        node.barrier()
        work = node.local(inbox).reshape(-1)[: work.shape[0]]
    return work[None]


def run_pipeline(backend: str, n_nodes: int = 4, device=None) -> torch.Tensor:
    N = n_nodes
    ctx = gasnet.Context(N, node_axis="node", backend=backend, device=device)
    aspace = ctx.address_space()
    aspace.register("inbox", (128,), torch.float32)
    inbox = aspace.alloc("inbox")
    ramp = torch.from_numpy(np.linspace(-1, 1, 128, dtype=np.float32))
    x = ramp.to(ctx.device)[None].tile((N, 1))
    return ctx.spmd(pipeline_program, inbox, x, out_specs=P("node"))


def kv_handoff(n_nodes: int = 4, device=None, S: int = 32, KH: int = 2,
               Dh: int = 16, seed: int = 0):
    """Act 3: every node (playing prefill on the ring) writes its KV block
    at offset S*KH*Dh of its right neighbor's cache segment with ONE
    GAScore offset put.  Returns (segment after, kv)."""
    N = n_nodes
    ctx = gasnet.Context(N, node_axis="node", backend="gascore", device=device)
    kv = torch.from_numpy(
        np.random.default_rng(seed).normal(size=(N, S * KH * Dh))
        .astype(np.float32)
    ).to(ctx.device)
    empty = torch.zeros((N, 2 * S * KH * Dh), dtype=torch.float32,
                        device=ctx.device)
    off = torch.tensor(S * KH * Dh, dtype=torch.int32, device=ctx.device)

    def handoff(node, seg, kv_l):
        # the sender writes its computed KV block at offset S*KH*Dh of the
        # decode node's cache segment
        return transport.offset_put(
            seg[0], kv_l[0], off, node.my_id, k=1, n=N
        )[None]

    seg = ctx.spmd(handoff, empty, kv, in_specs=(P("node"), P("node")),
                   out_specs=P("node"))
    return seg, kv


def run(backend: str = "gascore", n_nodes: int = 4, device=None,
        verbose: bool = True) -> Dict[str, torch.Tensor]:
    say = print if verbose else (lambda *a, **k: None)
    N = n_nodes
    res: Dict[str, torch.Tensor] = {}
    say("Act 1: run the pipeline on the SOFTWARE engine (indexing transport)")
    sw = run_pipeline("xla", N, device)
    say("  node 0 out[:4] =", sw[0, :4].tolist())

    say(f"Act 2: migrate to the HARDWARE engine ({backend}: GAScore CUDA "
        "kernels)")
    hw = run_pipeline(backend, N, device)
    say("  node 0 out[:4] =", hw[0, :4].tolist())
    np.testing.assert_allclose(sw.cpu().numpy(), hw.cpu().numpy(), rtol=1e-6)
    say("  identical results — zero application changes.")

    say("Act 2b: MIX them — a heterogeneous node map, software and hardware")
    say("nodes cooperating in ONE job (the paper's cluster, §II)")
    backends = node_backends(N, pattern="alternating")  # sw, hw, sw, hw
    say("  node map:", dict(enumerate(backends)))
    mixed = run_pipeline(",".join(backends), N, device)
    np.testing.assert_allclose(sw.cpu().numpy(), mixed.cpu().numpy(),
                               rtol=1e-6)
    say("  identical results again — each rank on its own engine, one API.")
    res["sw"], res["hw"], res["mixed"] = sw, hw, mixed

    say("Act 3: disaggregated serving — prefill node puts a KV cache into the")
    say("decode node's memory with ONE one-sided GAScore transfer")
    seg, kv = kv_handoff(N, device)
    got, kvn = seg.cpu().numpy(), kv.cpu().numpy()
    half = kvn.shape[1]
    for d in range(N):
        np.testing.assert_allclose(got[d, half:], kvn[(d - 1) % N])
    res["kv_seg"], res["kv"] = seg, kv
    say("  KV cache landed at the receiver-side offset chosen by the sender —")
    say("  the GAScore command format (local addr, node, remote addr, len).")
    return res


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="gascore",
                    help="engine of act 2 (default: gascore)")
    ap.add_argument("--n-nodes", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    run(args.backend, args.n_nodes, args.device)


if __name__ == "__main__":
    main()
