"""Tensor-parallel decode suite, on one device: planned TP-group
all-reduce parity over mixed engine maps, head-sharded paged decode
servers, and TP decode groups inside the disaggregated cluster.

Port of ``repro.testing.tp_suite``.  The reference runs each group over
its own devices; here every rank of a group lies on one device, its
shards stacked (``parallel.tp.stack_shards``), and the group's programs
run under ``Context.spmd``.  Each check raises ``AssertionError`` on a
failure.

Run: ``python -m repro_torch.testing.tp_suite [--device cpu]`` (prints
``TP_SUITE_PASS``).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["group_all_reduce", "all_reduce_parity", "smoke_requests", "server_parity",
           "cluster_parity", "main"]

TP = 2
BACKENDS = ("xla", "gascore", "xla,gascore")


def group_all_reduce(x: torch.Tensor, backend: str,
                     dtype: torch.dtype) -> torch.Tensor:
    """The planned all-reduce of a ``("tp",)`` group of ``x.shape[0]``
    ranks on ``backend``, rank ``r`` contributing ``x[r]`` in ``dtype``
    (the group's program under ``Context.spmd``, on ``x``'s device):
    every rank's result, stacked."""
    from repro_torch.core import gasnet, sched

    gas = gasnet.Context(x.shape[0], node_axis="tp", backend=backend,
                         device=x.device)
    return gas.spmd(
        lambda node, v: sched.all_reduce(node.engine, v[0].to(dtype))[None], x)


def all_reduce_parity(device, backends=BACKENDS, tp: int = TP,
                      dtypes=(torch.float32, torch.bfloat16)) -> None:
    """A ``tp``-rank group over a ``("tp",)`` axis — the shape and axis the
    sharded decode step uses — with the planned collective, on pure
    software, pure hardware and mixed engine maps, in each of ``dtypes``.
    At 2 ranks every schedule is one exchange-and-add, so parity is
    BITWISE: every rank holds ``x[0] + x[1]`` in the payload's dtype."""
    x = (torch.arange(2.0 * 4 * 1 * 128, device=device).reshape(2, 4, 1, 128)
         / 37.0 - 5.0)
    for dt in dtypes:
        want = (x[0].to(dt) + x[1].to(dt)).float()
        for b in backends:
            out = group_all_reduce(x, b, dt).float()
            if not torch.equal(out[0], out[1]):
                raise AssertionError(f"all-reduce not replicated on {b}")
            if not torch.equal(out[0], want):
                raise AssertionError(f"all-reduce != sum on {b} ({dt})")


def smoke_requests(vocab: int) -> List[Tuple[int, List[int], int]]:
    """The reference suite's five requests: (rid, prompt, max_new), every
    other one sharing a 9-token prefix."""
    rng = np.random.default_rng(11)
    shared = rng.integers(0, vocab, 9).tolist()
    reqs = []
    for rid in range(5):
        prompt = (shared + rng.integers(0, vocab, 3).tolist()
                  if rid % 2 == 0 else
                  rng.integers(0, vocab, int(rng.integers(5, 12))).tolist())
        reqs.append((rid, prompt, int(rng.integers(4, 8))))
    return reqs


def _serve(srv, reqs) -> Dict[int, List[int]]:
    from repro_torch.launch.serve import Request

    for rid, prompt, mx in reqs:
        srv.submit(Request(rid=rid, prompt=list(prompt), max_new=mx))
    for _ in range(400):
        if len(srv.finished) == len(reqs):
            break
        srv.step()
    if len(srv.finished) != len(reqs):
        raise AssertionError("server stalled")
    return {r.rid: list(r.out) for r in srv.finished}


def server_parity(model, ctx, params, device,
                  backends=("xla", "xla,gascore")) -> Dict[str, Dict]:
    """``TPPagedServer`` (tp=2) against ``PagedServer``: token parity on
    the suite's requests for each group backend.  Returns the tokens."""
    from repro_torch.launch.serve import PagedServer, TPPagedServer

    kw = dict(device=device, page_tokens=8, n_pool_pages=14)
    reqs = smoke_requests(model.cfg.vocab)
    out = {"tp1": _serve(PagedServer(model, ctx, params, 3, 32, **kw), reqs)}
    for b in backends:
        out[b] = _serve(TPPagedServer(model, ctx, params, 3, 32, tp=TP,
                                      tp_backend=b, **kw), reqs)
        for rid, want in out["tp1"].items():
            if out[b][rid] != want:
                raise AssertionError((b, rid, out[b][rid], want))
    return out


def cluster_parity(model, ctx, params, device,
                   tp_backend: str = "xla,gascore") -> Dict:
    """A cluster of 1 prefill rank and one tp=2 decode group against 1
    prefill + 1 decode rank: token parity, every push acknowledged.
    Returns the TP cluster's stats."""
    from repro_torch.launch.serve import Request
    from repro_torch.serving.disagg import DisaggCluster

    reqs = smoke_requests(model.cfg.vocab)

    def run(**kw):
        cl = DisaggCluster(model, ctx, params, n_prefill=1, decode_batch=2,
                           cache_len=32, page_tokens=8, paged=True,
                           device=device, **kw)
        for rid, prompt, mx in reqs:
            cl.submit(Request(rid=rid, prompt=list(prompt), max_new=mx))
        stats = cl.run_until_drained(max_ticks=500)
        return {r.rid: list(r.out) for r in cl.finished}, stats

    base, _ = run(n_decode=1)
    got, stats = run(n_decode=TP, tp=TP, tp_backend=tp_backend)
    if stats["tp"] != TP or stats["n_decode_groups"] != 1:
        raise AssertionError(f"not one tp={TP} group: {stats}")
    if stats["kv_acked"] != len(reqs):
        raise AssertionError(f"acked {stats['kv_acked']} of {len(reqs)}")
    for rid, want in base.items():
        if got.get(rid) != want:
            raise AssertionError((rid, got.get(rid), want))
    return stats


def main(argv=None) -> None:
    from repro_torch.compat import resolve_device
    from repro_torch.configs.registry import SMOKE
    from repro_torch.models.build import build_model
    from repro_torch.parallel.ctx import RunCtx

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    all_reduce_parity(device)
    print("TP all-reduce parity OK (xla/gascore/mixed, f32+bf16, bitwise)")
    model, ctx = build_model(SMOKE["qwen3-4b"]), RunCtx()
    params = model.init(ctx, torch.Generator(device=device).manual_seed(0),
                        device=device)
    server_parity(model, ctx, params, device)
    print("TPPagedServer token parity OK (tp=2, xla + mixed map)")
    cluster_parity(model, ctx, params, device)
    print("DisaggCluster TP decode group parity OK (1 prefill + tp=2 group)")
    print("TP_SUITE_PASS")


if __name__ == "__main__":
    main()
