"""The port's fault-tolerant elastic serving against the JAX reference, on
the CPU.

Each scenario of the port's fault suite (``repro_torch.testing.
fault_suite``) runs at the reference suite's sizes with the reference's
SMOKE weights (carried across through numpy): the faulted run's tokens
must equal its no-failure twin's (the suite asserts it) and the
reference's colocated ``Server``'s on the same requests.  The reference's
own ``DisaggCluster`` needs several XLA devices and is not run here.  A
dead rank's segment row holds the poison word after every consume, and
the stores alias the segment throughout.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import SMOKE as J_SMOKE
from repro.launch import serve as jserve
from repro.models.build import build_model as j_build
from repro.parallel.ctx import RunCtx as JCtx
from repro_torch.configs.registry import SMOKE
from repro_torch.launch.serve import Request
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.obs import export
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel.ctx import RunCtx
from repro_torch.serving.disagg import POISON_BITS, DisaggCluster
from repro_torch.testing import fault_suite as fs

SCENARIOS = ["kill_decode", "quorum_restore", "elastic_join",
             "heartbeat_delay", "chaos"]


@pytest.fixture(scope="module")
def models():
    cfg = J_SMOKE["qwen3-4b"]
    jm = j_build(cfg)
    jctx = JCtx(mesh=None, remat="none")
    jparams, _ = jm.init(jctx, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return (jm, jctx, jparams), (build_model(SMOKE["qwen3-4b"]), RunCtx(),
                                 tparams)


@pytest.fixture(scope="module")
def runs(models):
    """Every scenario once, on the CPU: each run's requests, tokens and
    cluster, by scenario and label (twin, faulted)."""
    _, (tm, ctx, tparams) = models
    out = {}

    def scenario(name, go):
        seen = out[name] = {}

        def run(label, *a, **kw):
            reqs = [Request(rid=r.rid, prompt=list(r.prompt),
                            max_new=r.max_new) for r in a[3]]
            reqs += [Request(rid=r.rid, prompt=list(r.prompt),
                             max_new=r.max_new)
                     for r in kw.get("late_reqs", ())]
            cl, stats, toks = fs.run_cluster(*a, **kw)
            seen[label] = {"requests": reqs, "tokens": toks, "stats": stats,
                           "cluster": cl}
            return cl, stats, toks

        seen["result"] = go(run)

    kw = dict(device="cpu")
    scenario("kill_decode", lambda run: fs.scenario_kill_decode(
        tm, ctx, tparams, run=run, **kw))
    scenario("quorum_restore", lambda run: fs.scenario_quorum_restore(
        tm, ctx, tparams, run=run, **kw))
    scenario("elastic_join", lambda run: fs.scenario_elastic_join(
        tm, ctx, tparams, run=run, **kw))
    scenario("heartbeat_delay", lambda run: fs.scenario_heartbeat_delay(
        tm, ctx, tparams, run=run, **kw))
    scenario("chaos", lambda run: fs.scenario_chaos(
        tm, ctx, tparams, 0, run=run, **kw))
    return out


def _reference_tokens(models, reqs, batch=2, cache=48):
    (jm, jctx, jparams), _ = models
    server = jserve.Server(jm, jctx, jparams, batch, cache)
    for r in reqs:
        server.submit(jserve.Request(rid=r.rid, prompt=list(r.prompt),
                                     max_new=r.max_new))
    server.run_until_drained()
    return {r.rid: r.out for r in server.finished}


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_tokens_equal_twin_and_reference_server(models, runs, name):
    twin, faulted = runs[name]["twin"], runs[name]["faulted"]
    assert faulted["tokens"] == twin["tokens"]
    assert sorted(faulted["tokens"]) == sorted(r.rid for r in twin["requests"])
    assert twin["tokens"] == _reference_tokens(models, twin["requests"])


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_survivors_keep_their_books(runs, name):
    """The AM plane's books after a death (every surviving push acked,
    nothing dropped), the drained pools of the live groups and the tier,
    and the segment left where it was allocated."""
    faulted = runs[name]["faulted"]
    cl, stats = faulted["cluster"], faulted["stats"]
    fs.check_survivors(cl)
    assert stats["am_dropped"] == 0
    assert stats["requests"] == len(faulted["requests"])
    live = [g for g in range(cl.n_groups) if not cl._group_down(g)]
    assert all(cl.stores[g].n_free == cl.pages_per_rank for g in live)
    pool_elems = cl.pages_per_rank * cl.shard_layout.page_elems
    for g, store in enumerate(cl.stores):
        row = cl.kvseg[cl.decode_rank(g), :pool_elems]
        assert store.mem.data_ptr() == row.data_ptr()
        assert store.mem.untyped_storage().data_ptr() == (
            cl.kvseg.untyped_storage().data_ptr())


def test_kill_decode_dies_mid_handoff_and_reroutes(runs):
    res, st = runs["kill_decode"]["result"], runs["kill_decode"]["faulted"]
    (tick, phase, rank), = res["log"]
    assert phase == "pre_consume" and res["cluster"].roles[rank] == "decode"
    assert st["stats"]["recovered_reroutes"] >= 1
    assert st["stats"]["heartbeat_failed"] == [rank]
    assert fs.dead_row_poisoned(res["cluster"], rank)


def test_quorum_restore_reads_the_surviving_replica(runs):
    st = runs["quorum_restore"]["faulted"]["stats"]
    assert st["tier_quorum_restores"] >= 1 and st["recovered_recompute"] == 0
    assert st["sched_swaps"] >= 1 and st["tier_replica_pages"] >= 1


def test_elastic_join_serves_from_the_spares_row(runs):
    res = runs["elastic_join"]["result"]
    cl = res["cluster"]
    assert cl.roles[res["joined"]] == "decode"
    assert cl.group_leaders[-1] == res["joined"] == cl.n - 1
    assert res["served_on_joined"] >= 1
    st = runs["elastic_join"]["faulted"]["stats"]
    assert st["migrated_prefix_pages"] >= 1 and st["elastic_joins"] == 1
    assert cl.stores[-1].mem.data_ptr() == cl.kvseg[cl.n - 1].data_ptr()


def test_chaos_plan_matches_the_references_draws():
    """chaos(seed) draws its kill as the reference does."""
    for seed in range(6):
        rng = np.random.default_rng(seed)
        want = (int(rng.choice([1, 2, 3, 4, 5])), int(rng.integers(2, 12)),
                str(rng.choice(["tick", "pre_consume"])))
        assert fs.chaos_plan(seed) == want


@pytest.mark.parametrize("phase", ["tick", "pre_consume"])
def test_dead_row_is_poison_after_every_consume_and_stores_alias(models,
                                                                  phase):
    """A decode rank killed at a tick's start or in the mid-handoff window:
    after every later consume its whole row holds ``POISON_BITS`` (NaN in
    every lane of every dtype a page carries: f32 and both bf16 halves),
    the segment tensor keeps its storage and every store stays a view of
    its rank's row."""
    _, (tm, ctx, tparams) = models
    cl = DisaggCluster(tm, ctx, tparams, n_prefill=1, n_decode=2, n_spare=1,
                       paged=True, page_tokens=8, decode_batch=2,
                       cache_len=48, decode_backend="gascore", device="cpu")
    ptr, mems = cl.kvseg.data_ptr(), [s.mem.data_ptr() for s in cl.stores]

    def hook(c, ph, tick):
        if ph == phase and tick == 2:
            c.kill_rank(2)

    cl.fault_hook = hook
    for r in fs.make_requests(tm.cfg.vocab, np.random.default_rng(3)):
        cl.submit(r)
    orig = cl._consume_transfer
    after = []

    def consume(results):
        orig(results)
        if cl.killed:
            after.append(cl.kvseg[2].clone())

    cl._consume_transfer = consume
    stats = cl.run_until_drained()
    assert stats["rank_failures"] == 1 and after
    for row in after:
        bits = row.view(torch.int32)
        assert bool((bits == POISON_BITS).all())
        assert bool(torch.isnan(row).all())
        halves = row.view(torch.bfloat16)
        assert bool(torch.isnan(halves).all())
    assert cl.kvseg.data_ptr() == ptr
    assert [s.mem.data_ptr() for s in cl.stores] == mems
    for g, store in enumerate(cl.stores):
        assert store.mem.data_ptr() == cl.kvseg[cl.decode_rank(g)].data_ptr()


def test_float32_quiet_nan_would_leave_bf16_lanes_finite():
    """Why the poison is all ones: f32's quiet NaN has a 0.0 low bf16
    half, so a bf16 page read from a row filled with it would not be all
    NaN."""
    quiet = torch.full((4,), float("nan"), dtype=torch.float32)
    assert not bool(torch.isnan(quiet.view(torch.bfloat16)).all())
    poison = torch.full((4,), POISON_BITS, dtype=torch.int32).view(
        torch.float32)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert bool(torch.isnan(poison.view(dt)).all())


def test_recovery_traces_a_death_and_dumps_the_flight_recorder(models):
    """With the tracer on, a death is a ``rank_death`` instant and one
    flight dump; the exported trace of the faulted run is valid against
    the registry's RMA counters."""
    _, (tm, ctx, tparams) = models
    tracer = obs_trace.enable(obs_trace.Tracer(capacity=1 << 16))
    try:
        inj = fs.FaultInjector([{"tick": 2, "phase": "tick", "kill": 1}])
        cl, stats, _ = fs.run_cluster(
            tm, ctx, tparams, fs.make_requests(tm.cfg.vocab,
                                               np.random.default_rng(3)),
            hook=inj, metrics=tracer.registry, device="cpu",
            **fs.SMOKE.shape(n_prefill=1, n_decode=2, n_memory=2, n_spare=1))
    finally:
        obs_trace.disable()
    assert stats["rank_failures"] == 1 and len(cl.flight_dumps) == 1
    dump = cl.flight_dumps[0]
    assert dump["rank"] == 1 and dump["reason"] == "rank 1 (decode) died"
    deaths = [e for e in tracer.events if e.name == "rank_death"]
    assert [e.tick0 for e in deaths] == [dump["tick"]] == [2 + 3]
    assert any(e["name"] == "rank_death" for e in dump["events"])
    trace = export.chrome_trace(tracer, labels=["fault"])
    assert export.validate(trace, tracer.registry) == []
    assert any(ev.get("name") == "rank_death" and ev.get("s") == "g"
               for ev in trace["traceEvents"])


def test_kill_outside_the_ring_and_join_without_a_spare_refused(models):
    """As in the reference: a rank outside the ring cannot be killed, a
    cluster without a live spare cannot grow."""
    _, (tm, ctx, tparams) = models
    paged = DisaggCluster(tm, ctx, tparams, paged=True, page_tokens=8,
                          cache_len=48, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        paged.kill_rank(7)
    with pytest.raises(RuntimeError, match="no live spare"):
        paged.join_decode_rank()
    spare = DisaggCluster(tm, ctx, tparams, paged=True, page_tokens=8,
                          cache_len=48, device="cpu", n_spare=1)
    spare.kill_rank(2)
    with pytest.raises(RuntimeError, match="no live spare"):
        spare.join_decode_rank()


def test_fault_suite_main_runs_on_cpu(capsys, tmp_path):
    path = tmp_path / "trace.json"
    fs.main(["--fast", "--device", "cpu", "--trace", str(path)])
    out = capsys.readouterr().out
    for marker in ("kill-decode OK", "died mid-handoff", "elastic-join OK",
                   "heartbeat-delay OK", "trace OK", "FAULT_SUITE_PASS"):
        assert marker in out
    assert path.stat().st_size > 0
