"""The port's fault-tolerance control plane, flight recorder, attribution and
health hook against the JAX reference, on the CPU.

The same inputs go to both packages: ``runtime.ft`` (heartbeats,
stragglers, elastic plans) must reach the same decisions; ``obs.export``
and ``obs.attrib`` must give equal dicts and strings for the same events
recorded on each package's tracer; the FT halves of the memory tier and
the pool (replicated legs, quorum restores, failure scrubbing, prefix
migration) must keep the same books; ``PagedServer(health=...)`` must
defer the same admissions and produce the reference's tokens.
``chip_smoke.py``'s ``serve_ft`` phase runs here at the SMOKE size: its
launch schedule matches the kernel calls the clusters make.
"""

import dataclasses

import jax
import numpy as np
import pytest

import chip_smoke

from repro.configs.registry import SMOKE as J_SMOKE
from repro.core.sched import EngineCost as JEngineCost
from repro.launch import mesh as jmesh
from repro.launch import serve as jserve
from repro.models.build import build_model as j_build
from repro.obs import attrib as jattrib
from repro.obs import export as jexport
from repro.obs import health as jhealth
from repro.obs import trace as jtrace
from repro.parallel.ctx import RunCtx as JCtx
from repro.runtime import ft as jft
from repro.serving import pool as jpool
from repro.serving import tier as jtier
from repro.serving.scheduler import SLO as JSLO
from repro_torch.configs.registry import SMOKE
from repro_torch.core.sched import EngineCost
from repro_torch.kernels import ops
from repro_torch.launch import mesh, serve
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.obs import attrib, export, health
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel.ctx import RunCtx
from repro_torch.runtime import ft
from repro_torch.serving import pool, tier
from repro_torch.serving.scheduler import SLO
from repro_torch.testing import fault_suite as fs


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


# --------------------------------------------------------------------------- #
# runtime.ft: the same inputs, the same decisions
# --------------------------------------------------------------------------- #
def _beats(mod, n, timeout, script):
    """Drive a HeartbeatMonitor of ``mod`` through ``script`` — (time,
    beating nodes, admitted nodes) steps — and record every decision."""
    clk = Clock()
    mon = mod.HeartbeatMonitor(range(n), timeout_s=timeout, clock=clk)
    out = []
    for t, beating, admitted in script:
        clk.t = t
        for r in beating:
            mon.beat(r)
        for r in admitted:
            mon.admit(r)
        out.append((mon.check(), mon.failed, mon.alive))
    return out


@pytest.mark.parametrize("n,timeout,script", [
    # the reference test: node 3 silent, a stale beat, a rejoin
    (4, 5.0, [(3.0, (0, 1, 2), ()), (7.0, (), ()), (7.0, (3,), ()),
              (8.0, (), ()), (8.0, (), (3,))]),
    (6, 1.0, [(2.0, (0, 5), ())]),
    # a tick clock: silent for exactly timeout ticks is still alive
    (3, 3.0, [(1.0, (0, 1), ()), (2.0, (0, 1), ()), (3.0, (0, 1), ()),
              (4.0, (0, 1), ()), (4.0, (2,), ()), (5.0, (0,), (2,))]),
])
def test_heartbeat_monitor_decides_as_the_reference(n, timeout, script):
    assert _beats(ft, n, timeout, script) == _beats(jft, n, timeout, script)


def _stragglers(mod, n, kw, steps):
    tr = mod.StragglerTracker(range(n), **kw)
    out = []
    for times in steps:
        for node, t in times.items():
            tr.record(node, t)
        out.append([(d.node_id, d.action, d.ratio) for d in tr.assess()])
        out.append((dict(tr.strikes), dict(tr.ewma)))
    tr.drop(0)
    out.append((dict(tr.strikes), dict(tr.ewma), tr.assess() == []))
    return out


@pytest.mark.parametrize("n,kw,steps", [
    # the reference's quarantine after patience
    (4, dict(alpha=1.0, threshold=1.5, patience=2),
     [{0: 1.0, 1: 1.0, 2: 1.0, 3: 3.0}] * 3),
    # and its recovery: strikes reset
    (3, dict(alpha=1.0, threshold=1.5, patience=2),
     [{0: 1.0, 1: 1.0, 2: 5.0}, {2: 1.0}]),
    # EWMA smoothing, the default policy
    (5, {}, [{0: 1.0, 1: 1.2, 2: 0.9, 3: 1.1, 4: 4.0},
             {4: 3.5, 0: 1.0}, {4: 1.0}, {4: 6.0, 1: 0.5}]),
    (2, dict(alpha=0.5), [{0: 0.0, 1: 0.0}, {1: 2.0}]),  # zero median
])
def test_straggler_tracker_decides_as_the_reference(n, kw, steps):
    assert _stragglers(ft, n, kw, steps) == _stragglers(jft, n, kw, steps)


def test_straggler_decision_is_the_references_record():
    assert [f.name for f in dataclasses.fields(ft.StragglerDecision)] == [
        f.name for f in dataclasses.fields(jft.StragglerDecision)]
    assert ft.StragglerDecision(3, "quarantine", 2.0) == ft.StragglerDecision(
        3, "quarantine", 2.0)


@pytest.mark.parametrize("n_alive", [0, 1, 15, 16, 17, 31, 255, 260, 496,
                                     511, 512, 1000])
@pytest.mark.parametrize("width,pods", [(1, 1), (4, 2), (16, 1), (16, 2),
                                        (8, 4), (0, 1)])
def test_elastic_plan_matches_reference(n_alive, width, pods):
    assert ft.elastic_plan(n_alive, width, prefer_pods=pods) == (
        jft.elastic_plan(n_alive, width, prefer_pods=pods))


# --------------------------------------------------------------------------- #
# obs.export: the same events on both tracers, the same trace and dumps
# --------------------------------------------------------------------------- #
def _stamp(tr):
    """Deterministic wall stamps (both packages' tracers read the host
    clock): event i spans [10 i, 10 i + 3 + i] us."""
    for i, e in enumerate(tr.events):
        e.t0_us = 10.0 * i
        e.t1_us = e.t0_us if e.kind == "instant" else e.t0_us + 3.0 + i
    return tr


def _traced_tick(mod):
    """The reference test's tick: nested scoped spans, a split-phase RMA
    closed inside, a lifecycle instant; then a rank death and an elastic
    join on the next tick."""
    tr = mod.Tracer()
    tr.set_tick(1)
    with tr.span("tick", cat="tick"):
        with tr.span("decode", cat="decode", rank=0):
            h = tr.begin_async("put_nb", cat="rma", bytes=512, rank=0)
            tr.instant("req_retire", cat="req", rid=0, rank=0, tokens=2)
            tr.end_async(h)
    tr.set_tick(2)
    with tr.span("tick", cat="tick"):
        tr.instant("heartbeat_miss", cat="ft", rank=3)
        tr.instant("rank_death", cat="ft", rank=3, role="decode")
        h = tr.begin_async("get_nb", cat="rma", bytes=4096, rank=1)
        tr.end_async(h)
        tr.instant("elastic_join", cat="ft", rank=5, group=2)
    return _stamp(tr)


def _leaky(mod):
    tr = mod.Tracer()
    sp = tr.begin_async("get_nb", cat="rma", bytes=64)
    tr.end_async(sp)
    leak = tr.begin_async("get_nb", cat="rma", bytes=64)
    tr.events.append(leak)
    _stamp(tr)
    return tr, leak.sid


def _overlapping(mod):
    tr = mod.Tracer()
    tr.set_tick(0)
    a = tr.begin("a", cat="x")
    b = tr.begin("b", cat="x")
    tr.end(a)
    tr.end(b)
    return _stamp(tr)


def test_event_dicts_and_chrome_trace_match_reference():
    ours, theirs = _traced_tick(obs_trace), _traced_tick(jtrace)
    assert [export.event_dict(e) for e in ours.events] == [
        jexport.event_dict(e) for e in theirs.events]
    for labels in (None, ["cluster"]):
        got = export.chrome_trace(ours, labels=labels)
        assert got == jexport.chrome_trace(theirs, labels=labels)
        assert export.validate(got, ours.registry) == []
    two = export.chrome_trace([ours, _traced_tick(obs_trace)], ["a", "b"])
    assert two == jexport.chrome_trace([theirs, _traced_tick(jtrace)],
                                       ["a", "b"])


def test_annotating_tracer_exports_the_references_events():
    """The port's profiler ranges (``annotate``) are not exported: the same
    events give the reference's dicts."""
    tr = obs_trace.Tracer(annotate=("tick", "decode"))
    tr.set_tick(1)
    with tr.span("tick", cat="tick"):
        with tr.span("decode", cat="decode", rank=0):
            tr.instant("req_retire", cat="req", rid=0, rank=0, tokens=2)
    jt = jtrace.Tracer()
    jt.set_tick(1)
    with jt.span("tick", cat="tick"):
        with jt.span("decode", cat="decode", rank=0):
            jt.instant("req_retire", cat="req", rid=0, rank=0, tokens=2)
    assert export.chrome_trace(_stamp(tr)) == jexport.chrome_trace(_stamp(jt))


def test_validate_flags_what_the_reference_flags():
    (ours, lo), (theirs, lt) = _leaky(obs_trace), _leaky(jtrace)

    def strip(trace, sid):
        trace["traceEvents"] = [
            ev for ev in trace["traceEvents"]
            if not (ev.get("ph") == "e" and ev.get("id") == sid)]
        return trace

    got = export.validate(strip(export.chrome_trace(ours), lo))
    assert got == jexport.validate(strip(jexport.chrome_trace(theirs), lt))
    assert any("never ended" in p for p in got)

    ours, theirs = _traced_tick(obs_trace), _traced_tick(jtrace)
    t_ours, t_theirs = export.chrome_trace(ours), jexport.chrome_trace(theirs)
    ours.registry.counter("rma_put_nb_bytes").inc(1)
    theirs.registry.counter("rma_put_nb_bytes").inc(1)
    got = export.validate(t_ours, ours.registry)
    assert got == jexport.validate(t_theirs, theirs.registry)
    assert any("bit-equal" in p for p in got)

    got = export.validate(export.chrome_trace(_overlapping(obs_trace)))
    assert got == jexport.validate(jexport.chrome_trace(_overlapping(jtrace)))
    assert any("overlaps" in p for p in got)


@pytest.mark.parametrize("last,seed,rank", [(4, 42, 3), (1, None, None),
                                            (64, 7, 0)])
def test_flight_dump_and_summary_match_reference(last, seed, rank, tmp_path):
    ours, theirs = _traced_tick(obs_trace), _traced_tick(jtrace)
    reason = "rank 3 (decode) died"
    got = export.flight_dump(ours, last, reason=reason, seed=seed, rank=rank)
    want = jexport.flight_dump(theirs, last, reason=reason, seed=seed,
                               rank=rank)
    assert got == want and got["events"]
    for n in (40, 2):
        md = export.render_flight_summary(got, max_events=n)
        # the replay line names the port's suite
        assert md == jexport.render_flight_summary(want, max_events=n).replace(
            "python -m repro.testing.", "python -m repro_torch.testing.")
    if seed is not None:
        assert f"repro_torch.testing.fault_suite --seed {seed}" in md
    path = tmp_path / "trace.json"
    export.write_trace(export.chrome_trace(ours), str(path))
    jpath = tmp_path / "ref.json"
    jexport.write_trace(jexport.chrome_trace(theirs), str(jpath))
    assert path.read_bytes() == jpath.read_bytes()


# --------------------------------------------------------------------------- #
# obs.attrib: the same lifecycles, the same breakdowns and reports
# --------------------------------------------------------------------------- #
def _lifecycle(tr, rid, points):
    for name, t0, t1, args in points:
        if t1 is None:
            sp = tr.instant(name, cat="req", rid=rid, **args)
            sp.t0_us = sp.t1_us = float(t0)
        else:
            sp = tr.begin(name, cat="req", rid=rid, **args)
            tr.end(sp)
            sp.t0_us, sp.t1_us = float(t0), float(t1)


LIFECYCLES = {
    "swap": {0: [("req_submit", 0, None, {}), ("prefill", 100, 300, {}),
                 ("req_admit", 500, None, {}),
                 ("req_first_token", 500, None, {}),
                 ("req_preempt", 800, None, {"mode": "swap"}),
                 ("req_resume", 1400, None, {"mode": "swap"}),
                 ("req_retire", 2000, None, {"tokens": 8})],
             1: [("req_submit", 600, None, {}), ("req_admit", 700, None, {}),
                 ("req_retire", 1300, None, {"tokens": 4})]},
    "handoff": {0: [("req_submit", 0, None, {}), ("prefill", 0, 100, {}),
                    ("req_admit", 500, None, {}),
                    ("req_retire", 600, None, {"tokens": 2})]},
    "recompute": {5: [("req_submit", 0, None, {}), ("prefill", 0, 100, {}),
                      ("req_admit", 100, None, {}),
                      ("req_preempt", 300, None, {"mode": "recompute"}),
                      ("prefill", 500, 650, {}),
                      ("req_resume", 700, None, {"mode": "recompute"}),
                      ("req_retire", 1000, None, {"tokens": 5})]},
    "in_flight": {3: [("req_submit", 0, None, {}), ("req_admit", 50, None, {}),
                      ("req_preempt", 80, None, {"mode": "swap"})],
                  4: [("req_submit", 10, None, {}), ("prefill", 20, 40, {}),
                      ("req_admit", 60, None, {}),
                      ("req_retire", 90, None, {"tokens": 1})]},
}


@pytest.mark.parametrize("case", sorted(LIFECYCLES))
@pytest.mark.parametrize("with_cost", [False, True])
def test_attribute_and_why_slow_match_reference(case, with_cost):
    ours, theirs = obs_trace.Tracer(), jtrace.Tracer()
    for tr in (ours, theirs):
        for rid, points in LIFECYCLES[case].items():
            _lifecycle(tr, rid, points)
    cost = jcost = None
    if with_cost:
        cost = EngineCost(alpha_us=10.0, beta_us_per_kib=0.6,
                          gamma_us_per_kib=0.2)
        jcost = JEngineCost(alpha_us=10.0, beta_us_per_kib=0.6,
                            gamma_us_per_kib=0.2)
    got = attrib.attribute(ours, cost=cost)
    want = jattrib.attribute(theirs, cost=jcost)
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == {
        k: dataclasses.asdict(v) for k, v in want.items()}
    for rid in list(LIFECYCLES[case]) + [99]:
        assert attrib.why_slow(ours, rid, cost=cost) == jattrib.why_slow(
            theirs, rid, cost=jcost)
    for bd in got.values():
        assert bd.dominant() == want[bd.rid].dominant()


# --------------------------------------------------------------------------- #
# the FT halves of the tier, the pool and the role map
# --------------------------------------------------------------------------- #
def _replicated_tier(mod):
    t = mod.MemoryTier(3, 4, 2, host_backed=True, replicas=2)
    h = t.plan_swap_out(1, [1, 0])
    rows = np.arange(4, dtype=np.float32).reshape(2, 2)
    t.host_store(1, rows)
    legs = [np.stack([t.host_mem[pl.rank, s] for s in pl.slots])
            for pl in h.placements]
    out = [[(pl.rank, list(pl.slots)) for pl in h.placements], legs,
           t.replica_pages, t.restore_placement(1).rank, t.quorum_restores]
    mod.check_tier(t)
    out.append(t.mark_failed(h.rank))
    pl = t.restore_placement(1)
    out += [pl.rank, t.quorum_restores, t.host_load(1)]
    t.release(1)
    mod.check_tier(t)
    out += [t.free_slots(h.rank), t.n_free, t.stats()]
    return out


def test_replicated_swap_out_and_quorum_restore_match_reference():
    got, want = _replicated_tier(tier), _replicated_tier(jtier)
    np.testing.assert_equal(got, want)


def _failures(mod):
    t = mod.MemoryTier(2, 4, 2, replicas=2)
    out = []
    h = t.plan_swap_out(5, [0], replicas=1)
    out.append(len(h.placements))
    out.append(t.mark_failed(h.rank))
    out.append(5 in t.holdings)
    with pytest.raises(mod.TierError):
        t.restore_placement(5)
    out.append(t.mark_failed(h.rank))
    mod.check_tier(t)
    h2 = t.plan_swap_out(6, [0, 1], replicas=2)
    out.append(len(h2.placements))
    t.release(6)
    t.admit_rank(h.rank)
    with pytest.raises(mod.TierError):
        t.admit_rank(h.rank)
    out.append(t.free_slots(h.rank))
    t.plan_swap_out(7, [0, 1, 2], replicas=1)
    before = t.degraded_placements
    h3 = t.plan_swap_out(8, [0, 1], replicas=2)
    out += [len(h3.placements), t.degraded_placements - before]
    mod.check_tier(t)
    out.append(t.stats())
    return out


def test_tier_failure_scrubbing_degradation_and_readmit_match_reference():
    assert _failures(tier) == _failures(jtier)


def test_serve_roles_spares_and_promotion_match_reference():
    roles = mesh.serve_roles(1, 2, n_memory=1, n_spare=2)
    assert roles == jmesh.serve_roles(1, 2, n_memory=1, n_spare=2)
    assert roles == ("prefill", "decode", "decode", "memory", "spare", "spare")
    for kw in ({"decode": "gascore"}, {"spare": "xla"}):
        assert mesh.role_backends(roles, **kw) == jmesh.role_backends(roles, **kw)
    assert mesh.promote_spare(roles, 4) == jmesh.promote_spare(roles, 4)
    for rank, to in ((1, "decode"), (9, "decode"), (4, "spare")):
        with pytest.raises(ValueError):
            mesh.promote_spare(roles, rank, to=to)
        with pytest.raises(ValueError):
            jmesh.promote_spare(roles, rank, to=to)


@pytest.fixture(scope="module")
def layouts():
    jm, jctx = j_build(J_SMOKE["qwen3-4b"]), JCtx(mesh=None, remat="none")
    tm, ctx = build_model(SMOKE["qwen3-4b"]), RunCtx()
    return (
        pool.PagedLayout.from_struct(
            tm.kv_block_struct(ctx, prompt_len=4, cache_len=32),
            cache_len=32, page_tokens=8),
        jpool.PagedLayout.from_struct(
            jm.kv_block_struct(jctx, prompt_len=4, cache_len=32),
            cache_len=32, page_tokens=8),
    )


def _migration(mod, layout):
    donor, target = mod.PagedKVStore(layout, 8), mod.PagedKVStore(layout, 8)
    rng = np.random.default_rng(0)
    pages = rng.normal(size=(layout.n_pages, layout.page_elems)).astype(
        np.float32)
    shared = list(range(100, 117))
    donor.admit(1, shared, pages)
    donor.admit(2, shared + [7], pages)
    out = [donor.shared_page_count(1)]
    entries = donor.prefix_entries()
    out.append([(list(c), p) for c, p in entries])
    pairs = target.adopt_prefix(entries)
    out += [pairs, target.adopt_prefix(entries), target.stats()]
    donor.pin_pages([dp for dp, _ in pairs])
    donor.release(1)
    donor.release(2)
    out.append([int(donor.state.refcnt[dp]) for dp, _ in pairs])
    mod.check_pool(donor.state, tables=list(donor.tables.values()))
    donor.unpin_pages()
    out.append(donor.n_free)
    plan = target.admit(3, shared + [9], pages)
    out.append((list(plan.table), list(plan.fresh)))
    target.release(3)
    out += [target.release_prefix_cache(), target.n_free]
    mod.check_pool(target.state)
    store = mod.PagedKVStore(layout, 4)
    store.note_swap_out(5, 3, replicas=1)
    out += [store.stats(), dict(store.swapped_replicated)]
    store.note_swap_in(5)
    store.note_swap_in(99)
    store.note_swap_out(6, 2, replicas=0)
    out.append(dict(store.swapped_replicated))
    return out


def test_prefix_migration_and_replica_books_match_reference(layouts):
    ours, theirs = layouts
    assert ours.page_elems == theirs.page_elems
    assert _migration(pool, ours) == _migration(jpool, theirs)


# --------------------------------------------------------------------------- #
# PagedServer(health=...): backpressure, against the reference's server
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def models():
    cfg = J_SMOKE["qwen3-4b"]
    jm = j_build(cfg)
    jctx = JCtx(mesh=None, remat="none")
    jparams, _ = jm.init(jctx, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return (jm, jctx, jparams), (build_model(SMOKE["qwen3-4b"]), RunCtx(),
                                 tparams)


def _backpressure(srv_cls, req_cls, slo_cls, mon, m, ctx, params, vocab, **kw):
    """The reference test's script: a tight-TPOT request at priority 2 keeps
    the floor raised, a priority-0 request behind it is deferred."""
    rng = np.random.default_rng(4)
    srv = srv_cls(m, ctx, params, 2, 32, page_tokens=8, health=mon, **kw)
    assert srv.scheduler.health is mon
    trail = []
    srv.submit(req_cls(rid=0, prompt=rng.integers(0, vocab, 8).tolist(),
                       max_new=4, slo=slo_cls(priority=2, tpot_deadline_s=1e-9)))
    srv.step()
    trail.append(mon.backpressure_floor())
    srv.submit(req_cls(rid=1, prompt=rng.integers(0, vocab, 8).tolist(),
                       max_new=4, slo=slo_cls(priority=0)))
    srv.step()
    trail.append((srv.scheduler.deferrals,
                  [r.rid for r in srv.active if r is not None]))
    stats = srv.run_until_drained(max_ticks=300)
    trail.append((stats["requests"], stats["sched_deferrals"],
                  mon.last_summary["tracked"],
                  mon.registry.counter("slo_violations").get() >= 1))
    return trail, {r.rid: r.out for r in srv.finished}


def test_paged_server_health_backpressure_matches_reference(models):
    (jm, jctx, jparams), (tm, ctx, tparams) = models
    vocab = tm.cfg.vocab
    got, got_toks = _backpressure(serve.PagedServer, serve.Request, SLO,
                                  health.HealthMonitor(), tm, ctx, tparams,
                                  vocab, device="cpu")
    want, want_toks = _backpressure(jserve.PagedServer, jserve.Request, JSLO,
                                    jhealth.HealthMonitor(), jm, jctx, jparams,
                                    vocab)
    assert got == want
    assert got[0] == 2 and got[1][0] >= 1 and got[2][:2] == (2, got[2][1])
    assert got_toks == want_toks


def test_paged_server_without_backpressure_only_observes(models):
    """A monitor built with ``backpressure=False`` is tracked and ticked but
    not attached: nothing is deferred; the tokens are the server's without
    a monitor."""
    _, (tm, ctx, tparams) = models
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tm.cfg.vocab, 8).tolist() for _ in range(3)]

    def run(mon):
        srv = serve.PagedServer(tm, ctx, tparams, 2, 32, page_tokens=8,
                                device="cpu", health=mon)
        for i, p in enumerate(prompts):
            srv.submit(serve.Request(rid=i, prompt=list(p), max_new=4,
                                     slo=SLO(priority=i % 2,
                                             tpot_deadline_s=1e-9)))
        st = srv.run_until_drained(max_ticks=300)
        return st, {r.rid: r.out for r in srv.finished}, srv

    mon = health.HealthMonitor(backpressure=False)
    st, toks, srv = run(mon)
    assert srv.scheduler.health is None and st["sched_deferrals"] == 0
    assert mon.last_summary["tracked"] == 0
    assert toks == run(None)[1]


# --------------------------------------------------------------------------- #
# chip_smoke's serve_ft phase, at the SMOKE size
# --------------------------------------------------------------------------- #
@pytest.fixture
def calls(monkeypatch):
    """Count the kernel calls that reach ``kernels.ops`` (one launch each
    on the card)."""
    seen = dict.fromkeys(list(chip_smoke.GAS_KERNELS) + ["paged_attention"], 0)
    for name in seen:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            seen[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(ops, name, counted)
    return seen


FT_SCENARIOS = ["kill_decode", "quorum_restore", "elastic_join",
                "heartbeat_delay", "chaos"]


def test_chip_smoke_serve_ft_schedule(models, calls):
    """chip_smoke's ``ft_scenarios`` at the SMOKE size: each scenario's
    runs launch what the clusters' own schedule says (gated inside), the
    phase's total is the sum of its runs', detection comes the heartbeat
    timeout (plus one for a mid-handoff kill) after the kill, one flight
    dump a death, and the twin's tokens hold the faulted run's."""
    _, (tm, ctx, tparams) = models
    records, runs = chip_smoke.ft_scenarios(tm, ctx, tparams, fs.SMOKE, "cpu",
                                            counter=lambda: dict(calls))
    assert sorted(records) == sorted(FT_SCENARIOS)
    assert len(runs) == 2 * len(FT_SCENARIOS)
    assert {k: sum(r[k] for r in runs) for k in calls} == calls
    assert min(calls[k] for k in chip_smoke.DISAGG_KERNELS) > 0
    for name, rec in records.items():
        assert rec["near_ties"] == 0
        assert rec["requests_token_identical"] > 0
        assert rec["launches"]["perm_put"] > 0
        kills = rec["kills"]
        assert len(rec["flight_dump_events"]) == rec["rank_failures"] == len(
            kills)
        for (tick, phase, _), seen in zip(kills, rec["detected_at"]):
            assert seen - tick == 3 + (phase == "pre_consume")
    assert records["kill_decode"]["kills"][0][1] == "pre_consume"
    assert records["quorum_restore"]["recovered_recompute"] == 0
    assert records["elastic_join"]["served_on_joined"] >= 1
    assert records["elastic_join"]["migrated_prefix_pages"] > 0
    assert records["heartbeat_delay"]["rank_failures"] == 0
    assert not obs_trace.active().enabled
