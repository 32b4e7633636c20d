"""Quickstart: the GASNet-style PGAS API in five minutes, on the port.

Eight "nodes" (ranks stacked on one GPU), one partitioned global address
space, one-sided puts/gets — blocking (Core API) and split-phase
non-blocking (Extended API) — Active Messages with handlers, and a ring
all-reduce built from neighbor puts: the paper's programming model end to
end.  Sections 1-7 of the reference's ``examples/quickstart.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--backend xla|gascore|xla,gascore] [--n-nodes 8] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from repro_torch.core import collectives, gasnet, sched
from repro_torch.core.gasnet import P


def run(backend: str = "xla", n_nodes: int = 8, device=None,
        verbose: bool = True) -> Dict[str, torch.Tensor]:
    """Run sections 1-7; returns every printed or asserted tensor."""
    N = n_nodes
    say = print if verbose else (lambda *a, **k: None)
    ctx = gasnet.Context(N, node_axis="node", backend=backend, device=device,
                         am_payload_width=4)
    res: Dict[str, torch.Tensor] = {}

    # --- 1. attach a segment: every node owns a 64-float partition -------
    aspace = ctx.address_space()
    aspace.register("scratch", (64,), torch.float32)
    seg = aspace.alloc("scratch")
    say(f"segment 'scratch': {N} nodes x {aspace.spec('scratch').local_shape}")

    # --- 2. one-sided put: write into your right neighbor's memory -------
    def put_demo(node, seg):
        payload = torch.full((4,), 10.0, device=seg.device) + node.my_id
        seg = node.put(seg, payload, to=gasnet.Shift(1), index=8)
        node.barrier()
        return seg

    seg = ctx.spmd(put_demo, seg)
    res["put"] = seg
    say("after put, node 3 holds (from node 2):", seg[3, 8:12].tolist())

    # --- 3. one-sided get: read 4 floats from node (me+2) ----------------
    def get_demo(node, seg):
        return node.get(seg, frm=gasnet.Shift(2), index=8, size=4)[None]

    got = ctx.spmd(get_demo, seg, out_specs=P("node"))
    res["got"] = got
    say("node 0 got (from node 2):", got[0].tolist())

    # --- 4. Extended API: split-phase non-blocking put/get ----------------
    # put_nb initiates the transfer and returns a handle; independent
    # compute issued before node.sync(h) does not depend on the transfer.
    def overlap_demo(node, seg):
        h = node.put_nb(seg, torch.full((4,), 70.0, device=seg.device)
                        + node.my_id, to=gasnet.Shift(1), index=20)
        local = node.local(seg)[:16]
        stat = torch.tanh(local) @ torch.ones((16,), device=seg.device)
        seg = node.sync(h)                           # split-phase completion
        g = node.get_nb(seg, frm=gasnet.Shift(1), index=20, size=4)
        fetched = node.sync(g)                       # completes the get
        return seg, (fetched + 0.0 * stat)[None]

    seg, fetched = ctx.spmd(overlap_demo, seg, out_specs=(P("node"), P("node")))
    res["overlap_seg"], res["fetched"] = seg, fetched
    say("node 0 put_nb'd to node 1, then get_nb'd it back:",
        fetched[0].tolist())

    # --- 5. Active Messages: handler runs at the receiver -----------------
    @ctx.handlers.handler("accumulate")
    def h_acc(state, payload, args):
        out = dict(state)
        out["acc"] = state["acc"] + payload.sum() * args[0]
        return out

    def am_demo(node, seg):
        state = {"acc": torch.zeros((), device=seg.device)}
        dest = ((node.my_id + 3) % N).to(torch.int32)
        node.am_medium(dest, "accumulate",
                       payload=torch.ones((4,), device=seg.device), args=(2,))
        state = node.am_flush(state)  # route + run handlers
        return state["acc"][None]

    acc = ctx.spmd(am_demo, seg, out_specs=P("node"))
    res["acc"] = acc
    say("AM handler results (each node got one message, 4*1*2):",
        acc.tolist())

    # --- 6. collectives from one-sided puts (incl. broadcast + exchange) ---
    def coll_demo(node, x):
        e = node.engine
        ar = collectives.ring_all_reduce(e, node.local(x))
        bc = collectives.broadcast(e, node.local(x), root=2)
        ex = collectives.exchange(e, node.local(x))  # all-to-all, in flight
        return ar[None], bc[None], ex[None]

    x = torch.arange(float(N * 16), device=ctx.device).reshape(N, 16)
    ar, bc, ex = ctx.spmd(coll_demo, x, out_specs=(P("node"),) * 3)
    assert torch.allclose(ar[0], x.sum(0))
    assert torch.allclose(bc[5], x[2])
    res["ar"], res["bc"], res["ex"] = ar, bc, ex
    say("ring all-reduce / broadcast / exchange over one-sided puts: OK")

    # --- 7. the collective scheduler: size-aware plans + segmented rings ---
    for size in (1 << 10, 1 << 20, 1 << 24):  # 1 KiB, 1 MiB, 16 MiB
        say(" ", sched.plan_collective("all_reduce", nbytes=size,
                                       n_nodes=N).describe())

    def seg_demo(node, x):  # segmented ring all-reduce, 4 slices x depth 2
        return collectives.segmented_ring_all_reduce(
            node.engine, node.local(x), n_segments=4, depth=2)[None]

    seg_ar = ctx.spmd(seg_demo, x, out_specs=P("node"))
    assert torch.equal(seg_ar, ar)  # bit-identical
    res["seg_ar"] = seg_ar
    say("segmented ring all-reduce == monolithic (pipelined wire): OK")
    return res


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="xla")
    ap.add_argument("--n-nodes", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    run(args.backend, args.n_nodes, args.device)
    print("\nSwap --backend gascore (or a mixed map like 'xla,gascore') to")
    print("run the same program on the GAScore CUDA kernels")
    print("(see repro_torch.examples.heterogeneous_pipeline).")


if __name__ == "__main__":
    main()
