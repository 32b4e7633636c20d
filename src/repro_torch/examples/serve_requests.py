"""Disaggregated serving demo: prefill pool -> KV put -> decode pool.

The port of ``examples/serve_requests.py``, acts 1-3.  Four GASNet ranks
in one job, all on one device (``launch.mesh.serve_roles``): ranks 0-1
are the prefill pool, ranks 2-3 the decode pool.  Each finished
prefill's KV cache crosses the GAS layer as ``sched.plan_p2p``-planned
segmented split-phase puts into a staging slot of the decode rank's
segment; a ``kv_ready`` Active-Message request rides along and the
decode rank's handler replies an installation ack.  Completions flow
back on the same AM plane.

Act 2 replays the burst through the **global paged KV pool**
(``paged=True``): the prefill rank puts each page straight into its
allocator-assigned pool slot, and the two requests sharing a prompt
prefix resolve to the same physical pages — mapped, not moved.

Act 3 adds the **tiered KV memory**: a memory-only rank joins a
deliberately undersized pool; low-priority requests fill it, and
high-priority latecomers make the SLO scheduler preempt — victim pages
swap OUT to the memory rank as one vectored put and back IN at resume as
one vectored get, and every resumed request's tokens match the
unpressured run exactly.

Each act is held to the colocated server that runs its decode path, on
the same device, dtype, batch width and requests: act 1 (dense staging)
to ``Server``, acts 2 and 3 (paged) to ``PagedServer``.

Run:    python -m repro_torch.examples.serve_requests [--device cpu]
Smoke:  python -m repro_torch.examples.serve_requests --smoke --device cpu
(``--trace`` of the reference waits for the port's ``obs/export.py``.)
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.launch.serve import PagedServer, Request, Server
from repro_torch.serving.disagg import DisaggCluster
from repro_torch.serving.scheduler import SLO

N_PREFILL, N_DECODE, N_MEMORY = 2, 2, 1
PAGE_TOKENS = 8
SHARED_PREFIX = 2 * PAGE_TOKENS  # rid 0/1 share two full prompt pages


def make_requests(vocab: int, n: int, rng) -> List[Request]:
    shared = rng.integers(0, vocab, size=SHARED_PREFIX).tolist()
    reqs = []
    for rid in range(n):
        if rid < 2:
            # common prompt prefix: the paged cluster must map (not move)
            # the shared pages
            prompt = shared + rng.integers(0, vocab, size=rid + 1).tolist()
        else:
            plen = int(rng.integers(4, 20))
            prompt = rng.integers(0, vocab, size=plen).tolist()
        reqs.append(Request(rid=rid, prompt=prompt,
                            max_new=int(rng.integers(4, 10))))
    return reqs


def pressure_burst(vocab: int, scale: int = 1) -> List[Request]:
    """The reference's act-3 burst, its lengths times ``scale``: three
    long low-priority requests, then two shorter ones."""
    rng = np.random.default_rng(11)
    reqs = []
    for rid in range(5):
        plen = int(rng.integers(18, 28)) * scale
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab, size=plen).tolist(),
            max_new=(14 if rid < 3 else 8) * scale,
        ))
    return reqs


def serve(server: Any, reqs: List[Request]) -> Dict[int, List[int]]:
    for r in reqs:
        server.submit(r)
    server.run_until_drained()
    return {r.rid: r.out for r in server.finished}


def run_pressured(cluster: DisaggCluster, reqs: List[Request],
                  fill_ticks: int = 8) -> Dict[str, Any]:
    """Act 3's arrival pattern: the first three requests at priority 0,
    ``fill_ticks`` ticks, then the rest at priority 2."""
    for r in reqs[:3]:
        r.slo = SLO(priority=0)
        cluster.submit(r)
    for _ in range(fill_ticks):
        cluster.tick()  # the low-priority bulk occupies the pool
    for r in reqs[3:]:
        r.slo = SLO(priority=2)
        cluster.submit(r)
    return cluster.run_until_drained()


def check_tokens(name: str, want: Dict[int, List[int]],
                 got: Dict[int, List[int]]) -> None:
    if want.keys() != got.keys():
        raise AssertionError(f"{name}: finished {sorted(got)}, want {sorted(want)}")
    for rid in want:
        if want[rid] != got[rid]:
            raise AssertionError(f"{name}: rid {rid} {got[rid]} != {want[rid]}")


def check_handoff(stats: Dict[str, Any], n_requests: int) -> None:
    """The AM plane's books: every push acked, every completion
    notified, no message dropped."""
    problems = []
    if stats["requests"] != n_requests:
        problems.append(f"requests {stats['requests']} != {n_requests}")
    if stats["kv_acked"] != stats["kv_transfers"]:
        problems.append(f"kv_acked {stats['kv_acked']} != kv_transfers "
                        f"{stats['kv_transfers']}")
    if stats["completions_notified"] != n_requests:
        problems.append(f"completions_notified {stats['completions_notified']}"
                        f" != {n_requests}")
    if stats["am_dropped"] != 0:
        problems.append(f"am_dropped {stats['am_dropped']}")
    if problems:
        raise AssertionError("; ".join(problems))


def check_drained(cluster: DisaggCluster, stats: Dict[str, Any]) -> None:
    """Every page reference and tier slot came back (one pool a decode
    group)."""
    pages = len(cluster.stores) * cluster.pages_per_rank
    if stats["pool_free_pages"] != pages:
        raise AssertionError(f"pool not drained: {stats['pool_free_pages']} "
                             f"free of {pages}")
    if cluster.tier is not None and (
            stats["tier_free_slots"] != stats["tier_slots"]):
        raise AssertionError(f"tier not drained: {stats['tier_free_slots']} "
                             f"free of {stats['tier_slots']}")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small burst + strict round-trip asserts")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--cache-len", type=int, default=48)
    ap.add_argument("--decode-batch", type=int, default=2)
    ap.add_argument("--decode-backend", default="xla",
                    help="decode pool engine (try gascore: the paper's "
                         "hardware nodes serving the KV-install side)")
    args = ap.parse_args(argv)
    n_requests = 6 if args.smoke else args.requests

    from repro_torch.configs.registry import SMOKE
    from repro_torch.models.build import build_model
    from repro_torch.parallel.ctx import RunCtx

    device = resolve_device(args.device)
    cfg = SMOKE[args.arch]
    model, ctx = build_model(cfg), RunCtx()
    params = model.init(ctx, torch.Generator(device=device).manual_seed(0),
                        device=device)
    B, C = args.decode_batch, args.cache_len
    reqs = lambda: make_requests(cfg.vocab, n_requests,  # noqa: E731
                                 np.random.default_rng(7))
    common = dict(n_prefill=N_PREFILL, n_decode=N_DECODE, decode_batch=B,
                  cache_len=C, decode_backend=args.decode_backend,
                  device=device)

    print(f"cluster: {N_PREFILL} prefill + {N_DECODE} decode ranks "
          f"(roles over one GASNet job on {device})")
    cluster = DisaggCluster(model, ctx, params, **common)
    print("kv plan:", cluster.plan.describe())
    for r in reqs():
        cluster.submit(r)
    stats = cluster.run_until_drained()
    print(f"served {stats['requests']} requests, {stats['decoded_tokens']} "
          f"tokens in {stats['ticks']} ticks")
    print(f"throughput: {stats['tok_per_s']:.1f} tok/s  p50 latency: "
          f"{stats['p50_latency_s'] * 1e3:.0f}ms  p99: "
          f"{stats['p99_latency_s'] * 1e3:.0f}ms")
    print(f"kv transfers: {stats['kv_transfers']} x {stats['kv_block_bytes']}B "
          f"({stats['kv_bytes_per_s'] / 1e6:.2f} MB/s), acked via AM reply: "
          f"{stats['kv_acked']}")
    print(f"completions notified to prefill ranks (AM): "
          f"{stats['completions_notified']}")
    check_handoff(stats, n_requests)
    if stats["kv_transfers"] != n_requests or "p2p" not in stats["kv_plan"]:
        raise AssertionError(stats)
    check_tokens("act 1", serve(Server(model, ctx, params, B, C, device=device),
                                reqs()),
                 {r.rid: r.out for r in cluster.finished})
    print("parity: disaggregated tokens == colocated tokens (bit-exact KV "
          "handoff)")

    # ---- Act 2: the global paged KV pool --------------------------------
    paged = DisaggCluster(model, ctx, params, paged=True,
                          page_tokens=PAGE_TOKENS, **common)
    print(f"paged pool: {paged.pages_per_rank} pages/rank x "
          f"{paged.playout.page_bytes}B pages ({PAGE_TOKENS} tokens/page), "
          f"per-page plan: {paged.plan.describe()}")
    for r in reqs():
        paged.submit(r)
    pstats = paged.run_until_drained()
    print(f"paged: {pstats['kv_pages_sent']} pages shipped, "
          f"{pstats['kv_pages_shared']} prefix-shared pages mapped not moved "
          f"(hit rate {pstats['prefix_hit_rate']:.1%}), "
          f"{pstats['kv_bytes_per_s'] / 1e6:.2f} MB/s page traffic")
    check_handoff(pstats, n_requests)
    if pstats["kv_pages_shared"] < SHARED_PREFIX // PAGE_TOKENS:
        raise AssertionError(f"prefix pages were moved: {pstats}")
    check_drained(paged, pstats)
    colocated = PagedServer(model, ctx, params, B, C, device=device,
                            page_tokens=PAGE_TOKENS)
    check_tokens("act 2", serve(colocated, reqs()),
                 {r.rid: r.out for r in paged.finished})
    print("parity: paged tokens == colocated paged tokens (bit-exact page "
          "handoff, prefix pages shared)")

    # ---- Act 3: tiered KV memory — oversubscription + memory rank -------
    unpressured = serve(PagedServer(model, ctx, params, B, C, device=device,
                                    page_tokens=PAGE_TOKENS),
                        pressure_burst(cfg.vocab))
    tiered = DisaggCluster(
        model, ctx, params, n_prefill=1, n_decode=1, n_memory=N_MEMORY,
        decode_batch=B, cache_len=C, decode_backend=args.decode_backend,
        paged=True, page_tokens=PAGE_TOKENS,
        pages_per_rank=8,  # aggregate demand >= 1.5x this pool
        device=device,
    )
    reqs3 = pressure_burst(cfg.vocab)
    tstats = run_pressured(tiered, reqs3)
    print(f"tiered KV memory: {tstats['n_memory_ranks']} memory rank(s), "
          f"{tstats['sched_evictions']} preemption(s) "
          f"({tstats['sched_swaps']} swap / {tstats['sched_recomputes']} "
          f"recompute), {tstats['swap_out_bytes']}B out / "
          f"{tstats['swap_in_bytes']}B back over the vectored put/get, swap "
          f"plan: {tstats['swap_plan']}")
    print(f"health: {tiered.health.render()}")
    check_handoff(tstats, len(reqs3))
    if tstats["sched_swaps"] < 1:
        raise AssertionError("expected >= 1 swap to the memory rank")
    if tstats["sched_resumes"] != tstats["sched_evictions"]:
        raise AssertionError(tstats)
    check_tokens("act 3", unpressured, {r.rid: r.out for r in tiered.finished})
    print("parity: preempted+resumed tokens == unpressured tokens "
          "(bit-identical resume after swap to the memory rank)")
    check_drained(tiered, tstats)
    print("pool + memory tier fully drained at shutdown")
    print("DISAGG_SERVE_PASS")


if __name__ == "__main__":
    main()
