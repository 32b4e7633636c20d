"""Fault-injection suite of the port: ranks die, join and recover mid-flight.

Port of ``repro.testing.fault_suite``.  The reference forces 6 XLA host
devices, one a rank; here every rank of the cluster lies on one device,
its segment a row of the rank-stacked segment tensor, so the suite needs
no device count.  Deterministic rank-kill and heartbeat-delay injectors
drive the cluster's fault hook.  Every scenario compares a faulted run
against its no-failure twin and requires identical tokens: a killed
rank's segment row is poisoned the instant it dies
(``serving.disagg.POISON_BITS``), so a recovery that reads a dead rank's
bytes cannot pass.

Scenarios (``--fast`` runs the first, third and fourth; the full run adds
quorum restore and the chaos scenario, seeded by ``--seed``):

1. kill-a-decode-rank: 1P+2D+2M(+1 spare), one decode rank killed in the
   mid-KV-handoff window (after its admission put launched, before the
   ``kv_ready`` ack is consumed): every request completes, pool and tier
   invariants hold on the survivors.
2. quorum restore: ``tier_replicas=2`` under pressure, the PRIMARY leg's
   memory rank killed while requests sit swapped out: restores read the
   surviving replica, zero recompute fallbacks.
3. elastic join: a spare rank promotes into a new decode group, the
   prefix index migrates over one vectored get, the joined rank serves.
4. heartbeat delay: beats missed for no more ticks than the timeout do
   NOT trip failure detection.
5. chaos(seed): a kill drawn from the seed (victim role, tick, phase).

The sizes (pages, cache, requests) are a :class:`Size`; :data:`SMOKE`
is the reference's.  Each scenario takes ``run`` (how one cluster run is
made: the twin's and the faulted one's, told apart by their label) and
``parity`` (how the faulted tokens are held to the twin's), so a caller
on the card can watch the runs and gate them its own way.

Run: ``python -m repro_torch.testing.fault_suite [--fast] [--seed N]
[--device cpu] [--trace PATH]`` (prints ``FAULT_SUITE_PASS``).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["Size", "SMOKE", "FaultInjector", "make_requests", "quorum_burst",
           "run_cluster", "check_survivors", "assert_parity",
           "scenario_kill_decode", "scenario_quorum_restore",
           "scenario_elastic_join", "scenario_heartbeat_delay",
           "scenario_chaos", "main"]


@dataclasses.dataclass(frozen=True)
class Size:
    """The suite's sizes.  The mixed workload: even rids share a prompt
    prefix of ``shared_pages`` pages followed by ``rid + 1`` tokens (or a
    tail of ``even_tail`` tokens when given), odd rids are private prompts
    of ``private_len`` tokens; ``max_new`` new tokens each (ranges are
    ``[lo, hi)``).  The quorum burst: the serving example's pressure burst
    scaled by ``burst_scale`` on a pool of ``quorum_pages`` pages."""

    page_tokens: int = 8
    cache_len: int = 48
    decode_batch: int = 2
    n_requests: int = 6
    shared_pages: int = 2
    even_tail: Optional[Tuple[int, int]] = None
    private_len: Tuple[int, int] = (6, 20)
    max_new: Tuple[int, int] = (5, 10)
    burst_scale: int = 1
    quorum_pages: int = 8
    quorum_batch: int = 2

    def shape(self, **kw) -> Dict[str, Any]:
        return dict(decode_batch=self.decode_batch, cache_len=self.cache_len,
                    page_tokens=self.page_tokens, **kw)


SMOKE = Size()  # the reference suite's sizes


class FaultInjector:
    """Deterministic fault plan driven by the cluster's fault hook.

    Each event is ``{"tick": T, "phase": p, "kill": rank_or_fn}``: at the
    first hook firing with phase ``p`` and tick >= ``T`` the rank (or
    ``fn(cluster) -> rank | None``; None retries at the next firing) is
    killed.
    """

    def __init__(self, events):
        self.events = list(events)
        self.log = []

    def __call__(self, cluster, phase, tick):
        for ev in list(self.events):
            if ev["phase"] != phase or tick < ev["tick"]:
                continue
            rank = ev["kill"]
            if callable(rank):
                rank = rank(cluster)
            if rank is None:
                continue  # condition not met yet: retry on later ticks
            cluster.kill_rank(rank)
            self.log.append((tick, phase, rank))
            self.events.remove(ev)


def build_model_once(device):
    from repro_torch.configs.registry import SMOKE as SMOKE_ARCHS
    from repro_torch.models.build import build_model
    from repro_torch.parallel.ctx import RunCtx

    cfg = SMOKE_ARCHS["qwen3-4b"]
    model, ctx = build_model(cfg), RunCtx()
    params = model.init(ctx, torch.Generator(device=device).manual_seed(0),
                        device=device)
    return cfg, model, ctx, params


def make_requests(vocab: int, rng, n: Optional[int] = None,
                  size: Size = SMOKE) -> List[Any]:
    """The mixed workload: even rids share a prompt prefix (the hot pages
    replication protects), odd rids are private."""
    from repro_torch.launch.serve import Request

    n = size.n_requests if n is None else n
    shared = rng.integers(0, vocab, size=size.shared_pages
                          * size.page_tokens).tolist()
    reqs = []
    for rid in range(n):
        if rid % 2 == 0:
            tail = (rid + 1 if size.even_tail is None
                    else int(rng.integers(*size.even_tail)))
            prompt = shared + rng.integers(0, vocab, size=tail).tolist()
        else:
            plen = int(rng.integers(*size.private_len))
            prompt = rng.integers(0, vocab, size=plen).tolist()
        reqs.append(Request(rid=rid, prompt=prompt,
                            max_new=int(rng.integers(*size.max_new))))
    return reqs


def quorum_burst(vocab: int, size: Size = SMOKE) -> List[Any]:
    """The serving example's pressure burst: three long requests at
    priority 0, then two shorter ones at priority 2 (submitted late)."""
    from repro_torch.examples.serve_requests import pressure_burst
    from repro_torch.serving.scheduler import SLO

    reqs = pressure_burst(vocab, size.burst_scale)
    for r in reqs:
        r.slo = SLO(priority=0 if r.rid < 3 else 2)
    return reqs


def run_cluster(model, ctx, params, reqs, hook=None, ticks_before=0,
                late_reqs=(), max_ticks=800, *, join=False, beat_filter=None,
                setup=None, **kw):
    """One cluster run: submit ``reqs``, tick ``ticks_before`` times,
    promote a spare when ``join``, submit ``late_reqs``, drain.
    ``setup(cluster)`` runs after construction and again after a join
    (the joined group's server is new).  Returns (cluster, stats, tokens
    by rid)."""
    from repro_torch.serving.disagg import DisaggCluster

    cl = DisaggCluster(model, ctx, params, paged=True, **kw)
    cl.fault_hook = hook
    cl.beat_filter = beat_filter
    if setup is not None:
        setup(cl)
    for r in reqs:
        cl.submit(r)
    for _ in range(ticks_before):
        cl.tick()
    if join:
        cl.join_decode_rank()
        if setup is not None:
            setup(cl)
    for r in late_reqs:
        cl.submit(r)
    stats = cl.run_until_drained(max_ticks=max_ticks)
    toks = {r.rid: list(r.out) for r in cl.finished}
    return cl, stats, toks


def _run(label, *a, **kw):
    del label
    return run_cluster(*a, **kw)


def check_survivors(cl) -> None:
    """Pool and tier invariants on every surviving rank after drain."""
    from repro_torch.serving import pool, tier as tier_lib

    for g in range(cl.n_groups):
        if cl._group_down(g):
            continue
        store = cl.stores[g]
        pool.check_pool(store.state, tables=list(store.tables.values()))
    if cl.tier is not None:
        tier_lib.check_tier(cl.tier)
        assert not cl.tier.holdings, "tier not drained"


def assert_parity(base, got, what) -> None:
    assert set(got) == set(base), (
        f"{what}: finished rids {sorted(got)} != {sorted(base)}")
    for rid, want in base.items():
        assert got[rid] == want, (
            f"{what}: rid {rid} tokens diverged\n  want {want}\n  got  "
            f"{got[rid]}")


def dead_row_poisoned(cl, rank: int) -> bool:
    from repro_torch.serving.disagg import POISON_BITS

    row = cl.kvseg[rank]
    return bool(torch.isnan(row).all()) and bool(
        (row.view(torch.int32) == POISON_BITS).all())


# --------------------------------------------------------------------------- #
def scenario_kill_decode(model, ctx, params, *, size: Size = SMOKE,
                         run: Callable = _run,
                         parity: Callable = assert_parity, **kw) -> Dict:
    """1P+2D+2M(+1 spare idle): kill one decode rank in the mid-KV-handoff
    window; every request completes with the twin's tokens."""
    shape = size.shape(n_prefill=1, n_decode=2, n_memory=2, n_spare=1, **kw)
    reqs = lambda: make_requests(model.cfg.vocab,  # noqa: E731
                                 np.random.default_rng(3), size=size)
    _, _, base = run("twin", model, ctx, params, reqs(), **shape)

    def mid_handoff_target(cl):
        # a push whose put launched THIS tick and whose ack is about to
        # be consumed: killing its target now is the mid-handoff death
        for push in cl.pending_push:
            if push is not None and not cl._group_down(push[1]):
                return cl.decode_rank(push[1])
        return None

    inj = FaultInjector(
        [{"tick": 2, "phase": "pre_consume", "kill": mid_handoff_target}])
    cl, stats, toks = run("faulted", model, ctx, params, reqs(), hook=inj,
                          **shape)
    assert inj.log, "injector never fired (no mid-flight push found)"
    assert stats["rank_failures"] == 1, stats["rank_failures"]
    assert stats["recovered_reroutes"] + stats["recovered_recompute"] >= 1
    parity(base, toks, "kill-decode")
    check_survivors(cl)
    dead = inj.log[0][2]
    assert dead_row_poisoned(cl, dead), "dead rank's segment unpoisoned"
    print(f"kill-decode OK: rank {dead} died mid-handoff at tick "
          f"{inj.log[0][0]}, {stats['recovered_reroutes']} rerouted / "
          f"{stats['recovered_recompute']} recomputed, tokens bit-exact",
          flush=True)
    return {"cluster": cl, "stats": stats, "log": inj.log}


def scenario_quorum_restore(model, ctx, params, *, size: Size = SMOKE,
                            run: Callable = _run,
                            parity: Callable = assert_parity, **kw) -> Dict:
    """Replicated swap-outs survive a memory-rank loss: the pressure burst
    with ``tier_replicas=2``, the primary leg killed while holdings are
    out; restores read the surviving replica."""
    shape = dict(n_prefill=1, n_decode=1, n_memory=2,
                 pages_per_rank=size.quorum_pages, tier_replicas=2,
                 replicate_all_swaps=True, decode_batch=size.quorum_batch,
                 cache_len=size.cache_len, page_tokens=size.page_tokens, **kw)

    def go(label, hook):
        reqs = quorum_burst(model.cfg.vocab, size)
        return run(label, model, ctx, params, reqs[:3], hook=hook,
                   ticks_before=8, late_reqs=reqs[3:], **shape)

    _, bstats, base = go("twin", None)
    assert bstats["sched_swaps"] >= 1, "pressure burst produced no swap"
    assert bstats["tier_replica_pages"] >= 1, "no replicated swap pages"

    def primary_leg(cl):
        if cl.tier is None or not cl.tier.holdings:
            return None
        h = next(iter(cl.tier.holdings.values()))
        return cl.memory_rank(h.rank)

    inj = FaultInjector([{"tick": 9, "phase": "tick", "kill": primary_leg}])
    cl, stats, toks = go("faulted", inj)
    assert inj.log, "no holding was resident to kill under"
    assert stats["rank_failures"] == 1
    assert stats["tier_quorum_restores"] >= 1, stats
    assert stats["recovered_recompute"] == 0, (
        "replicated pages should never fall back to recompute", stats)
    parity(base, toks, "quorum-restore")
    check_survivors(cl)
    print(f"quorum-restore OK: memory rank {inj.log[0][2]} died with "
          f"{stats['tier_quorum_restores']} quorum restore(s), "
          f"0 recompute fallbacks, tokens bit-exact", flush=True)
    return {"cluster": cl, "stats": stats, "log": inj.log}


def scenario_elastic_join(model, ctx, params, *, size: Size = SMOKE,
                          run: Callable = _run,
                          parity: Callable = assert_parity, **kw) -> Dict:
    """A spare promotes into a new decode group mid-run; the prefix index
    migrates over a vectored get and the joined rank serves."""
    shape = size.shape(n_prefill=1, n_decode=1, n_spare=1, **kw)

    def go(label, join):
        reqs = make_requests(model.cfg.vocab, np.random.default_rng(5),
                             size=size)
        return run(label, model, ctx, params, reqs[:4], ticks_before=6,
                   late_reqs=reqs[4:], join=join, **shape)

    _, _, base = go("twin", False)
    cl, stats, toks = go("faulted", True)
    joined = cl.group_leaders[-1]
    assert cl.roles[joined] == "decode" and cl.n_groups == 2
    assert stats["elastic_joins"] == 1
    assert stats["migrated_prefix_pages"] >= 1, (
        "prefix index did not migrate", stats)
    served = len(cl.decode_servers[-1].finished)
    assert served >= 1, "joined rank served nothing"
    parity(base, toks, "elastic-join")
    # drop the adopted prefix cache and require a fully drained pool
    cl.stores[-1].release_prefix_cache()
    check_survivors(cl)
    print(f"elastic-join OK: rank {joined} promoted, "
          f"{stats['migrated_prefix_pages']} prefix page(s) migrated, "
          f"{served} request(s) served on the joined rank, tokens "
          f"bit-exact", flush=True)
    return {"cluster": cl, "stats": stats, "joined": joined,
            "served_on_joined": served}


def scenario_heartbeat_delay(model, ctx, params, *, size: Size = SMOKE,
                             run: Callable = _run,
                             parity: Callable = assert_parity, **kw) -> Dict:
    """Beats missed for as many ticks as the timeout are NOT a failure."""
    shape = size.shape(n_prefill=1, n_decode=1, heartbeat_timeout=3, **kw)
    reqs = lambda: make_requests(model.cfg.vocab,  # noqa: E731
                                 np.random.default_rng(7), n=4, size=size)
    _, _, base = run("twin", model, ctx, params, reqs(), **shape)
    # rank 1 goes silent for ticks 3..5 (3 missed beats == timeout; the
    # detector requires STRICTLY more), then recovers
    cl, stats, toks = run(
        "faulted", model, ctx, params, reqs(),
        beat_filter=lambda rank, tick: not (rank == 1 and 3 <= tick <= 5),
        **shape)
    assert stats["rank_failures"] == 0, (
        "delay below the timeout tripped failure detection", stats)
    assert not cl.monitor.failed
    parity(base, toks, "heartbeat-delay")
    print("heartbeat-delay OK: 3 missed beats < timeout declared nothing "
          "dead, tokens bit-exact", flush=True)
    return {"cluster": cl, "stats": stats}


def chaos_plan(seed: int) -> Tuple[int, int, str]:
    """The kill ``chaos(seed)`` draws: (victim rank: a decode, memory or
    spare rank; tick; phase)."""
    rng = np.random.default_rng(seed)
    victim = int(rng.choice([1, 2, 3, 4, 5]))
    tick = int(rng.integers(2, 12))
    phase = str(rng.choice(["tick", "pre_consume"]))
    return victim, tick, phase


def scenario_chaos(model, ctx, params, seed: int, *, size: Size = SMOKE,
                   run: Callable = _run, parity: Callable = assert_parity,
                   **kw) -> Dict:
    """A kill drawn from ``seed``: victim role (decode, memory, spare),
    tick and phase vary; parity and invariants must hold."""
    shape = size.shape(n_prefill=1, n_decode=2, n_memory=2, n_spare=1,
                       tier_replicas=2, replicate_all_swaps=True, **kw)
    reqs = lambda: make_requests(model.cfg.vocab,  # noqa: E731
                                 np.random.default_rng(seed + 1), size=size)
    _, _, base = run("twin", model, ctx, params, reqs(), **shape)
    victim, tick, phase = chaos_plan(seed)
    inj = FaultInjector([{"tick": tick, "phase": phase, "kill": victim}])
    cl, stats, toks = run("faulted", model, ctx, params, reqs(), hook=inj,
                          **shape)
    assert inj.log, "chaos kill never fired"
    assert stats["rank_failures"] == 1
    parity(base, toks, f"chaos(seed={seed})")
    check_survivors(cl)
    print(f"chaos OK: seed={seed} killed rank {victim} "
          f"({cl.roles[victim]}) at tick {tick}/{phase}, tokens bit-exact",
          flush=True)
    return {"cluster": cl, "stats": stats, "log": inj.log}


def main(argv=None) -> None:
    import os

    from repro_torch.compat import resolve_device
    from repro_torch.obs import export as obs_export
    from repro_torch.obs import trace as obs_trace

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="chaos scenario seed (echoed into summaries)")
    ap.add_argument("--fast", action="store_true",
                    help="fixed-seed subset (skips quorum + chaos)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a validated Chrome trace of one faulted "
                         "run here on success")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"fault_suite: seed={args.seed} fast={args.fast}", flush=True)
    _, model, ctx, params = build_model_once(device)
    kw = dict(device=device)

    # the suite runs under the tracer so a failing scenario leaves a
    # flight-recorder window with the replay seed
    tracer = obs_trace.enable(obs_trace.Tracer(capacity=1 << 16))
    try:
        scenario_kill_decode(model, ctx, params, **kw)
        scenario_elastic_join(model, ctx, params, **kw)
        scenario_heartbeat_delay(model, ctx, params, **kw)
        if not args.fast:
            scenario_quorum_restore(model, ctx, params, **kw)
            scenario_chaos(model, ctx, params, args.seed, **kw)
    except BaseException:
        dump = obs_export.flight_dump(
            tracer, 64,
            reason=f"fault_suite scenario failed (seed {args.seed})",
            seed=args.seed)
        summary = obs_export.render_flight_summary(dump)
        print(summary)
        step_summary = os.environ.get("GITHUB_STEP_SUMMARY")
        if step_summary:
            with open(step_summary, "a") as f:
                f.write(summary + "\n")
        raise
    else:
        if args.trace:
            # one faulted run alone: twin and faulted clusters each
            # restart the tick clock, so their streams cannot merge into
            # one valid timeline
            obs_trace.disable()
            replay = obs_trace.enable(obs_trace.Tracer(capacity=1 << 16))
            try:
                inj = FaultInjector([{"tick": 2, "phase": "tick", "kill": 1}])
                run_cluster(
                    model, ctx, params,
                    make_requests(model.cfg.vocab, np.random.default_rng(3)),
                    hook=inj, metrics=replay.registry,
                    **SMOKE.shape(n_prefill=1, n_decode=2, n_memory=2,
                                  n_spare=1, **kw))
                assert inj.log, "traced replay: kill never fired"
            finally:
                obs_trace.disable()
            trace = obs_export.chrome_trace(replay, labels=["chaos_replay"])
            problems = obs_export.validate(trace, replay.registry)
            if problems:
                for p in problems:
                    print(f"trace INVALID: {p}")
                raise SystemExit(
                    f"fault_suite trace failed export.validate with "
                    f"{len(problems)} problem(s)")
            obs_export.write_trace(trace, args.trace)
            print(f"trace OK: {args.trace} "
                  f"({len(trace['traceEvents'])} events, validated: "
                  f"spans nest, every RMA synced, bytes == counters)")
    finally:
        obs_trace.disable()

    print("FAULT_SUITE_PASS")


if __name__ == "__main__":
    main()
