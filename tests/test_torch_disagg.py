"""The port's disaggregated cluster against the JAX reference, on the CPU.

Host functions (serving roles, segment bounds, the handoff bijection, the
head-shard layout, the pool map, the heartbeat and health monitors) are
held against the reference's directly.  The data plane (segmented and
pred-gated puts, deferred in-place landing, the vectored page fetch and
the swap round trip) runs on the port's three backends and is held to
numpy oracles bit for bit; the segmented handoff property runs on the
port's lockstep simulator.  Acts 1-3 of the port's serving example run at
the SMOKE size with the reference's weights (carried across through
numpy): the cluster's tokens must equal the reference's colocated
``Server``'s.  The reference's own ``DisaggCluster`` needs several XLA
devices and is not run here.
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from repro.checkpoint import ckpt as jckpt
from repro.configs.registry import SMOKE as J_SMOKE
from repro.launch import mesh as jmesh
from repro.launch import serve as jserve
from repro.models.build import build_model as j_build
from repro.obs import health as jhealth
from repro.parallel.ctx import RunCtx as JCtx
from repro.runtime import ft as jft
from repro.serving import kv as jkv
from repro.serving import pool as jpool
from repro.serving.scheduler import SLO as JSLO
from repro_torch.checkpoint import ckpt
from repro_torch.configs.registry import SMOKE
from repro_torch.core import am, extended, gasnet, sched
from repro_torch.examples import serve_requests as ex
from repro_torch.kernels import ops
from repro_torch.launch import mesh, serve
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.obs import health
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel.ctx import RunCtx
from repro_torch.runtime import ft
from repro_torch.serving import kv, pool, tier
from repro_torch.serving.disagg import DisaggCluster
from repro_torch.serving.scheduler import SLO
from repro_torch.testing import disagg_suite
from repro_torch.testing.sim import run_spmd

BACKENDS = ["xla", "gascore", "xla,gascore"]
CACHE, BATCH, PAGE = 48, 2, 8  # the example's --smoke sizes


# --------------------------------------------------------------------------- #
# host functions, against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("args", [(1, 1, 0, 1, 0), (2, 2, 1, 1, 0),
                                  (1, 4, 2, 2, 1), (3, 6, 0, 3, 2)])
def test_serve_roles_and_decode_groups_match_reference(args):
    n_p, n_d, n_m, tp, n_s = args
    assert mesh.serve_roles(n_p, n_d, n_m, tp=tp, n_spare=n_s) == (
        jmesh.serve_roles(n_p, n_d, n_m, tp=tp, n_spare=n_s))
    assert mesh.decode_groups(n_p, n_d, tp) == jmesh.decode_groups(n_p, n_d, tp)


@pytest.mark.parametrize("bad", [(0, 1, 0, 1, 0), (1, 0, 0, 1, 0),
                                 (1, 3, 0, 2, 0), (1, 1, -1, 1, 0)])
def test_serve_roles_refuse_what_the_reference_refuses(bad):
    n_p, n_d, n_m, tp, n_s = bad
    with pytest.raises(ValueError):
        jmesh.serve_roles(n_p, n_d, n_m, tp=tp, n_spare=n_s)
    with pytest.raises(ValueError):
        mesh.serve_roles(n_p, n_d, n_m, tp=tp, n_spare=n_s)


def test_role_backends_and_promote_spare_match_reference():
    roles = jmesh.serve_roles(2, 2, 1, n_spare=2)
    for kw in ({}, {"decode": "gascore"},
               {"prefill": "gascore", "memory": "gascore", "spare": "xla"}):
        assert mesh.role_backends(roles, **kw) == jmesh.role_backends(roles, **kw)
    for to in ("prefill", "decode", "memory"):
        assert mesh.promote_spare(roles, 5, to=to) == jmesh.promote_spare(
            roles, 5, to=to)
    for rank, to in ((0, "decode"), (5, "spare"), (9, "decode")):
        with pytest.raises(ValueError):
            jmesh.promote_spare(roles, rank, to=to)
        with pytest.raises(ValueError):
            mesh.promote_spare(roles, rank, to=to)
    with pytest.raises(ValueError, match="unknown serving role"):
        mesh.role_backends(("router",))


@pytest.mark.parametrize("total,g", [(1, 1), (7, 3), (12, 12), (10, 64),
                                     (1180224, 5)])
def test_segment_bounds_match_reference(total, g):
    assert kv.segment_bounds(total, g) == jkv.segment_bounds(total, g)


def test_handoff_permutation_matches_reference():
    for n, edges in ((6, {0: 4, 1: 3}), (4, {}), (5, {2: 0, 0: 2}),
                     (3, {0: 1, 1: 2, 2: 0})):
        assert kv.handoff_permutation(n, edges) == jkv.handoff_permutation(
            n, edges)
    for n, edges, msg in ((4, {0: 2, 1: 2}, "duplicate destination"),
                          (3, {0: 3}, "outside")):
        with pytest.raises(ValueError, match=msg):
            kv.handoff_permutation(n, edges)


@pytest.fixture(scope="module")
def models():
    cfg = J_SMOKE["qwen3-4b"]
    jm = j_build(cfg)
    jctx = JCtx(mesh=None, remat="none")
    jparams, _ = jm.init(jctx, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return (jm, jctx, jparams), (build_model(SMOKE["qwen3-4b"]), RunCtx(), tparams)


@pytest.mark.parametrize("tp", [1, 2])
def test_shard_heads_matches_reference(models, tp):
    (jm, jctx, _), (tm, ctx, _) = models
    jl = jpool.PagedLayout.from_struct(
        jm.kv_block_struct(jctx, prompt_len=4, cache_len=32), cache_len=32,
        page_tokens=8)
    tl = pool.PagedLayout.from_struct(
        tm.kv_block_struct(ctx, prompt_len=4, cache_len=32), cache_len=32,
        page_tokens=8)
    js, jcols = jl.shard_heads(tp, 2)
    ts, tcols = tl.shard_heads(tp, 2)
    np.testing.assert_array_equal(tcols, jcols)
    assert ts.page_elems == js.page_elems
    assert [(lf.shape, lf.offset, lf.size) for lf in ts.leaves] == [
        (lf.shape, lf.offset, lf.size) for lf in js.leaves]
    with pytest.raises(ValueError, match="divide"):
        tl.shard_heads(3, 2)


def test_pool_map_matches_reference():
    a, b = pool.PoolMap(3, 5, 7), jpool.PoolMap(3, 5, 7)
    assert a.n_pages == b.n_pages
    for g in range(a.n_pages):
        assert (a.owner(g), a.local(g)) == (b.owner(g), b.local(g))
        assert a.global_id(a.owner(g), a.local(g)) == g
        assert int(a.offset(g, "cpu")) == int(b.offset(g))


def test_heartbeat_monitor_matches_reference():
    clocks = {"t": 0.0}
    mon = [cls([0, 1, 2], timeout_s=2.0, clock=lambda: clocks["t"])
           for cls in (ft.HeartbeatMonitor, jft.HeartbeatMonitor)]
    script = [(1.0, [0, 1, 2]), (2.0, [0, 2]), (3.0, [0, 2]), (4.5, [0]),
              (5.0, [0, 1]), (9.0, [])]
    for t, beats in script:
        clocks["t"] = t
        got = []
        for m in mon:
            for r in beats:
                m.beat(r)
            got.append((m.check(), m.failed, m.alive))
        assert got[0] == got[1]
    for m in mon:
        m.admit(1)
    assert mon[0].alive == mon[1].alive


def test_health_monitor_matches_reference():
    """The same scripted tick clock through both monitors: identical
    summaries, backpressure floors and renders."""
    mons = [health.HealthMonitor(), jhealth.HealthMonitor()]
    slos = [(SLO(priority=2, ttft_deadline_s=1.0, tpot_deadline_s=0.5),
             JSLO(priority=2, ttft_deadline_s=1.0, tpot_deadline_s=0.5)),
            (SLO(), JSLO())]
    for m, k in zip(mons, (0, 1)):
        m.track(0, slos[0][k], 0.0)
        m.track(1, slos[1][k], 0.0)
    script = [(0.5, None, {}), (0.85, 0, {}), (1.0, None, {0: 2}),
              (1.3, None, {0: 3}), (1.9, None, {}), (2.5, None, {0: 5})]
    for t, first, progress in script:
        out = []
        for m in mons:
            if first is not None:
                m.first_token(first, t)
            s = m.tick(int(t * 10), t, progress=progress)
            out.append((s, m.backpressure_floor(), m.render()))
        assert out[0] == out[1]
    for m in mons:
        m.retire(0)
    assert mons[0].tick(30, 3.0) == mons[1].tick(30, 3.0)


def test_checkpoint_bf16_leaves_are_byte_identical_to_reference():
    """F1: one tree saved by both packages; every .npy (bf16, f32 and
    int32 leaves, a 0-d bf16 among them) and the manifest are the same
    bytes."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(a, jnp.bfloat16), "b": jnp.asarray(a[0]),
             "s": jnp.asarray(a[0, 0], jnp.bfloat16),
             "i": jnp.arange(4, dtype=jnp.int32)}
    ttree = {"w": torch.from_numpy(a).to(torch.bfloat16),
             "b": torch.from_numpy(a[0].copy()),
             "s": torch.tensor(a[0, 0]).to(torch.bfloat16),
             "i": torch.arange(4, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(os.path.join(d, "j"), 3, jtree).wait()
        ckpt.save(os.path.join(d, "t"), 3, ttree).wait()
        names = sorted(os.listdir(os.path.join(d, "j", "step_0000000003")))
        assert names == sorted(os.listdir(os.path.join(d, "t",
                                                       "step_0000000003")))
        for f in names:
            with open(os.path.join(d, "j", "step_0000000003", f), "rb") as fj, \
                    open(os.path.join(d, "t", "step_0000000003", f), "rb") as ft_:
                assert fj.read() == ft_.read(), f
        back, _ = ckpt.restore(os.path.join(d, "t"), 3, ttree)
        for k in ttree:
            assert back[k].dtype == ttree[k].dtype
            assert torch.equal(back[k].view(torch.int16) if k in "ws"
                               else back[k],
                               ttree[k].view(torch.int16) if k in "ws"
                               else ttree[k])


# --------------------------------------------------------------------------- #
# the data plane on the port's backends, against numpy oracles
# --------------------------------------------------------------------------- #
def _ctx(n, backend):
    """The mixed map alternates software and hardware ranks at any n."""
    names = backend.split(",")
    return gasnet.Context(n, backend=[names[r % len(names)] for r in range(n)],
                          device="cpu", am_capacity=4, am_payload_width=1)


def _blocks(n, block, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(-(2**31), 2**31 - 1, size=(n, block), dtype=np.int64)
    return bits.astype(np.int32).view(np.float32)  # NaN patterns included


def _push(backend, n, block, g, gate=None, n_slots=2, slot=1, defer=False):
    """Every rank pushes its block to rank (me+1) % n at ``slot``,
    segmented ``g`` ways; the landing synced in the program, or deferred
    and landed in place after it."""
    blocks = _blocks(n, block, block + n)
    gate = torch.ones(n, dtype=torch.bool) if gate is None else torch.tensor(gate)
    seg = torch.zeros((n, n_slots * block))

    def program(node, seg, blk, gate):
        hs, plan = kv.push_block(node, seg, blk[0], to=gasnet.Shift(1),
                                 base_index=slot * block, pred=gate[0],
                                 n_segments=g)
        assert plan.op == "p2p" and len(hs) == min(g, block)
        if defer:
            return [tuple(x[None] for x in node.defer(h)) for h in hs]
        return kv.sync_push(node, seg, hs)

    out = _ctx(n, backend).spmd(program, seg, torch.from_numpy(blocks), gate)
    if defer:
        for cmd in out:
            extended.land(seg, *cmd)
        out = seg
    return blocks, out.numpy()


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,block,g", [(2, 7, 1), (3, 16, 4), (4, 33, 5)])
def test_segmented_push_lands_whole_block(backend, n, block, g):
    for defer in (False, True):
        blocks, segs = _push(backend, n, block, g, defer=defer)
        for rank in range(n):
            assert segs[rank, block:].tobytes() == blocks[(rank - 1) % n].tobytes()
            assert not segs[rank, :block].view(np.int32).any()


@pytest.mark.parametrize("backend", BACKENDS)
def test_segmented_matches_monolithic_push(backend):
    _, mono = _push(backend, 3, 24, 1)
    _, segd = _push(backend, 3, 24, 6)
    _, landed = _push(backend, 3, 24, 6, defer=True)
    assert mono.tobytes() == segd.tobytes() == landed.tobytes()


@pytest.mark.parametrize("backend", BACKENDS)
def test_pred_gated_push_leaves_receiver_untouched(backend):
    n = 4
    gate = [r % 2 == 0 for r in range(n)]  # only even ranks send
    for defer in (False, True):
        blocks, segs = _push(backend, n, 8, 3, gate=gate, defer=defer)
        for rank in range(n):
            sender = (rank - 1) % n
            want = blocks[sender] if gate[sender] else np.zeros(8, np.float32)
            assert segs[rank, 8:].tobytes() == want.tobytes()


def test_land_clamps_and_gates_like_sync():
    """``extended.land`` of deferred commands (out-of-range offsets
    clamped, cleared flags, NaN payloads, chunked) equals the program's
    functional sync byte for byte, and writes in place."""
    n, S, L = 3, 40, 9
    rng = np.random.default_rng(5)
    base = torch.from_numpy(_blocks(n, S, 1))
    data = torch.from_numpy(_blocks(n, 2 * L, 2))
    offs = torch.tensor([[-4, 35], [3, 17], [31, 0]], dtype=torch.int32)
    flags = torch.from_numpy(rng.integers(0, 2, size=(n, 2)).astype(bool))

    def make(defer):
        def program(node, seg, d, o, f):
            hs = [node.put_nb(seg, d[0, j * L:(j + 1) * L],
                              to=gasnet.Shift(0), index=o[0, j], pred=f[0, j])
                  for j in range(2)]
            if defer:
                return [tuple(x[None] for x in node.defer(h)) for h in hs]
            for h in hs:
                seg = node.sync(h)
            return seg
        return program

    ctx = _ctx(n, "xla")
    want = ctx.spmd(make(False), base, data, offs, flags)
    cmds = ctx.spmd(make(True), base, data, offs, flags)
    seg = base.clone()
    ptr = seg.data_ptr()
    for cmd in cmds:
        extended.land(seg, *cmd, chunk=4)
    assert seg.data_ptr() == ptr
    assert seg.numpy().tobytes() == want.numpy().tobytes()
    with pytest.raises(TypeError, match="only puts"):
        ctx.spmd(lambda node, s: node.defer(node.get_nb(s, size=1)), base)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("g", [1, 3])
def test_fetch_pages_vectored_get_round_trip(backend, g):
    """Each rank prefetches 3 pages from its neighbour's pool shard with
    the split-phase vectored get: the owner's pages, bit for bit."""
    n, ppr, E = 3, 4, 6
    shards = _blocks(n, ppr * E, 9)
    pmap = pool.PoolMap(n, ppr, E)
    want_pages = (3, 0, 2)

    def program(node, seg):
        offs = torch.stack([pmap.offset(p, seg.device) for p in want_pages])
        hs, plan = pool.fetch_pages(node, seg, offs, frm=gasnet.Shift(1),
                                    page_elems=E, n_batches=g)
        assert plan.op == "p2p" and len(hs) == g
        return pool.sync_fetch(node, hs)[None]

    got = _ctx(n, backend).spmd(program, torch.from_numpy(shards)).numpy()
    for rank in range(n):
        owner = shards[(rank + 1) % n].reshape(ppr, E)
        assert got[rank].tobytes() == owner[list(want_pages)].tobytes()


@pytest.mark.parametrize("backend", BACKENDS)
def test_swap_out_swap_in_round_trip(backend):
    """Pool pages swap OUT to a memory rank's segment (vectored put) and
    back IN (vectored get + install) bit-exactly, NaN payloads included;
    the swap's landing deferred and written in place gives the same
    segments as the program's sync."""
    n, E, P = 3, 5, 4
    pages = _blocks(1, P * E, 0)[0]
    src_pages, dst_slots, new_pages = (3, 1), (0, 2), (0, 2)
    src = [p * E for p in src_pages]
    dst = [s * E for s in dst_slots]
    perm = gasnet.Perm(kv.handoff_permutation(n, {0: 1}))
    seg0 = torch.zeros((n, P * E))
    seg0[0] = torch.from_numpy(pages)
    flags = torch.tensor([[1, 1], [0, 0], [0, 0]], dtype=torch.int32)

    def out(defer):
        def program(node, seg, f):
            hs, plan = tier.swap_out_pages(node, seg, src, dst, to=perm,
                                           page_elems=E, flags=f[0])
            assert plan.op == "p2p"
            if defer:
                return [tuple(x[None] for x in node.defer(h)) for h in hs]
            for h in hs:
                seg = node.sync(h)
            return seg
        return program

    ctx = _ctx(n, backend)
    synced = ctx.spmd(out(False), seg0, flags)
    landed = seg0.clone()
    for cmd in ctx.spmd(out(True), seg0, flags):
        extended.land(landed, *cmd)
    assert landed.numpy().tobytes() == synced.numpy().tobytes()
    mem = synced[1].numpy().reshape(P, E)
    for sp, ds in zip(src_pages, dst_slots):
        assert mem[ds].tobytes() == pages.reshape(P, E)[sp].tobytes()
    assert not synced[2].numpy().view(np.int32).any()  # nothing shipped

    tier_seg = torch.zeros((n, P * E))
    tier_seg[1] = synced[1]

    def back(node, seg, f):
        h = node.get_nbv(seg, frm=perm, indices=torch.tensor(dst),
                         size=E, pred=f[0].max() > 0)
        fetched = node.sync(h)
        return tier.install_pages(node, seg, fetched,
                                  [p * E for p in new_pages], f[0])

    restored = ctx.spmd(back, tier_seg, flags)[0].numpy().reshape(P, E)
    for sp, npg in zip(src_pages, new_pages):
        assert restored[npg].tobytes() == pages.reshape(P, E)[sp].tobytes()


SET_SIM = settings(max_examples=10, deadline=None)


@SET_SIM
@given(n=st.integers(2, 5), block=st.integers(1, 48),
       n_segments=st.integers(1, 9), n_slots=st.integers(1, 3),
       seed=st.integers(0, 2**31 - 1))
def test_segmented_kv_handoff_bitexact(n, block, n_segments, n_slots, seed):
    """The reference's property on the port's lockstep simulator: any
    segment count, any bit pattern, the same landed block."""
    slot = seed % n_slots
    blocks = torch.from_numpy(_blocks(n, block, seed))

    def program(g):
        def run(engine):
            node = gasnet.Node(engine, am.HandlerTable(), am_capacity=4,
                               am_payload_width=1, am_per_peer_capacity=4)
            seg = torch.zeros((1, n_slots * block))
            hs, _ = kv.push_block(node, seg, blocks[engine.rank],
                                  to=gasnet.Shift(1),
                                  base_index=slot * block, n_segments=g)
            return kv.sync_push(node, seg, hs)
        return run

    segmented = run_spmd(program(n_segments), n)
    mono = run_spmd(program(1), n)
    for rank, (a, b) in enumerate(zip(segmented, mono)):
        assert a.numpy().tobytes() == b.numpy().tobytes()
        got = a[0, slot * block:(slot + 1) * block].numpy()
        assert got.tobytes() == blocks[(rank - 1) % n].numpy().tobytes()


# --------------------------------------------------------------------------- #
# the cluster: acts 1-3 against the reference's colocated Server
# --------------------------------------------------------------------------- #
def _reference_tokens(models, reqs, batch=BATCH, cache=CACHE):
    (jm, jctx, jparams), _ = models
    server = jserve.Server(jm, jctx, jparams, batch, cache)
    for r in reqs:
        server.submit(jserve.Request(rid=r.rid, prompt=list(r.prompt),
                                     max_new=r.max_new))
    server.run_until_drained()
    return {r.rid: r.out for r in server.finished}


def _cluster(models, **kw):
    _, (tm, ctx, tparams) = models
    base = dict(n_prefill=ex.N_PREFILL, n_decode=ex.N_DECODE,
                decode_batch=BATCH, cache_len=CACHE, device="cpu")
    base.update(kw)
    return DisaggCluster(tm, ctx, tparams, **base)


def _smoke_requests(tm):
    return ex.make_requests(tm.cfg.vocab, 6, np.random.default_rng(7))


@pytest.mark.parametrize("decode_backend", ["xla", "gascore"])
def test_act1_dense_handoff_tokens_match_reference_server(models, decode_backend):
    tm = models[1][0]
    cluster = _cluster(models, decode_backend=decode_backend)
    for r in _smoke_requests(tm):
        cluster.submit(r)
    stats = cluster.run_until_drained()
    ex.check_handoff(stats, 6)
    assert stats["kv_transfers"] == 6 and "p2p" in stats["kv_plan"]
    want = _reference_tokens(models, _smoke_requests(tm))
    ex.check_tokens("act 1", want, {r.rid: r.out for r in cluster.finished})


@pytest.mark.parametrize("decode_backend", ["xla", "gascore"])
def test_act2_paged_pool_tokens_match_reference_server(models, decode_backend):
    tm = models[1][0]
    cluster = _cluster(models, decode_backend=decode_backend, paged=True,
                       page_tokens=PAGE)
    ptr = cluster.kvseg.data_ptr()
    for r in _smoke_requests(tm):
        cluster.submit(r)
    stats = cluster.run_until_drained()
    assert cluster.kvseg.data_ptr() == ptr
    ex.check_handoff(stats, 6)
    assert stats["kv_pages_shared"] >= ex.SHARED_PREFIX // PAGE
    ex.check_drained(cluster, stats)
    want = _reference_tokens(models, _smoke_requests(tm))
    ex.check_tokens("act 2", want, {r.rid: r.out for r in cluster.finished})
    pool.check_pool(cluster.stores[0].state)


def test_act3_memory_tier_tokens_match_reference_server(models):
    tm = models[1][0]
    cluster = _cluster(models, n_prefill=1, n_decode=1, n_memory=1,
                       decode_backend="gascore", memory_backend="gascore",
                       paged=True, page_tokens=PAGE, pages_per_rank=8)
    stats = ex.run_pressured(cluster, ex.pressure_burst(tm.cfg.vocab))
    ex.check_handoff(stats, 5)
    assert stats["sched_swaps"] >= 1
    assert stats["sched_resumes"] == stats["sched_evictions"]
    ex.check_drained(cluster, stats)
    tier.check_tier(cluster.tier)
    want = _reference_tokens(models, ex.pressure_burst(tm.cfg.vocab))
    ex.check_tokens("act 3", want, {r.rid: r.out for r in cluster.finished})


def test_segments_stay_in_place_and_alias_the_stores(models):
    """One (n, seg_elems) tensor for the cluster's life: every tick keeps
    its storage, and each decode store's pages are a view into its rank's
    row."""
    tm = models[1][0]
    cluster = _cluster(models, paged=True, page_tokens=PAGE, n_memory=1)
    ptr = cluster.kvseg.data_ptr()
    row = cluster.seg_elems * 4
    for d, store in enumerate(cluster.stores):
        assert store.mem.data_ptr() == ptr + cluster.decode_rank(d) * row
    for r in _smoke_requests(tm):
        cluster.submit(r)
    while not cluster.idle():
        cluster.tick()
        assert cluster.kvseg.data_ptr() == ptr
        assert all(s.mem.data_ptr() == ptr + cluster.decode_rank(d) * row
                   for d, s in enumerate(cluster.stores))


def test_decode_write_and_page_put_in_one_tick(models):
    tm = models[1][0]
    cluster = _cluster(models, n_prefill=1, n_decode=1, paged=True,
                       page_tokens=PAGE, decode_backend="gascore")
    rng = np.random.default_rng(4)
    mk = lambda rid, n: serve.Request(  # noqa: E731
        rid=rid, prompt=rng.integers(0, tm.cfg.vocab, size=n).tolist(),
        max_new=9)
    first, second = mk(0, 11), mk(1, 13)
    reqs = [dataclasses.replace(first, out=[]), dataclasses.replace(second, out=[])]
    got = disagg_suite.put_and_decode_in_one_tick(cluster, first, second)
    assert got == _reference_tokens(models, reqs)


def test_swap_out_of_a_page_written_that_tick(models):
    tm = models[1][0]
    cluster = _cluster(models, n_prefill=1, n_decode=1, n_memory=1,
                       paged=True, page_tokens=PAGE, decode_backend="gascore",
                       memory_backend="gascore")
    prompt = np.random.default_rng(6).integers(0, tm.cfg.vocab, size=14).tolist()
    victim = serve.Request(rid=0, prompt=prompt, max_new=12)
    got = disagg_suite.swap_out_of_a_fresh_write(cluster, victim)
    assert cluster.metrics.counter("sched_swaps").value == 1
    assert got == _reference_tokens(
        models, [serve.Request(rid=0, prompt=prompt, max_new=12)])


@pytest.mark.parametrize("what", ["spares without paged",
                                  "memory ranks without paged",
                                  "kill_rank on a dense cluster",
                                  "join_decode_rank at tp > 1"])
def test_cluster_refuses_what_the_reference_refuses(models, what):
    """The reference's refusals (``serving/disagg.py``): spare and memory
    ranks need the paged pool, fault injection needs it too, and an
    elastic join makes a tp=1 group only."""
    calls = {
        "spares without paged": lambda: _cluster(models, n_spare=1),
        "memory ranks without paged": lambda: _cluster(models, n_memory=1),
        "kill_rank on a dense cluster": lambda: _cluster(models).kill_rank(0),
        "join_decode_rank at tp > 1": lambda: _cluster(
            models, n_prefill=1, n_decode=2, tp=2, n_spare=1, paged=True,
            page_tokens=PAGE).join_decode_rank(),
    }
    with pytest.raises(ValueError, match="paged|tp == 1"):
        calls[what]()


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("argv,want", [
    (["--role", "both", "--paged", "--n-memory", "1"], "tier_slots: "),
    (["--role", "both", "--n-prefill", "2", "--n-decode", "2",
      "--decode-backend", "gascore"], "kv_acked: 4"),
    (["--role", "memory"], "role: memory"),
    (["--role", "prefill"], "kv_blocks_per_s: "),
])
def test_serve_main_roles_run_on_cpu(argv, want, capsys):
    serve.main(argv + ["--device", "cpu", "--requests", "4", "--batch", "2",
                       "--max-new", "3"])
    assert want in capsys.readouterr().out


def test_serve_requests_example_runs_on_cpu(capsys):
    ex.main(["--smoke", "--device", "cpu", "--decode-backend", "gascore"])
    assert "DISAGG_SERVE_PASS" in capsys.readouterr().out


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--role", "both", "--paged", "--n-memory", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        ex.main(["--smoke"])


# --------------------------------------------------------------------------- #
# chip_smoke's launch schedule for the cluster, at the SMOKE size
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


@pytest.mark.parametrize("act", ["dense", "paged", "tiered"])
def test_chip_smoke_disagg_schedule(models, calls, act):
    """chip_smoke's ``drive_act`` at the SMOKE size: the cluster's own
    launch schedule (``DisaggCluster.transfer_kernels``, summed in its
    stats) matches the kernel calls it makes (paged attention, perm_put,
    ring_shift), the tracer's tick walls cover every tick, and the tokens
    match the reference's."""
    tm = models[1][0]
    kw = dict(decode_backend="gascore")
    reqs = lambda: _smoke_requests(tm)  # noqa: E731
    if act == "paged":
        kw.update(paged=True, page_tokens=PAGE)
    if act == "tiered":
        kw.update(n_prefill=1, n_decode=1, n_memory=1, paged=True,
                  page_tokens=PAGE, pages_per_rank=8, memory_backend="gascore")
        reqs = lambda: ex.pressure_burst(tm.cfg.vocab)  # noqa: E731
    cluster = _cluster(models, **kw)
    rec = chip_smoke.drive_act(cluster, reqs(), pressured=act == "tiered",
                               counter=lambda: dict(calls))
    assert rec["launches"]["perm_put"] > 0 and rec["launches"]["ring_shift"] > 0
    assert (rec["launches"]["paged_attention"] > 0) == (act != "dense")
    st = rec["stats"]
    assert st["transfer_launches"] == {
        k: rec["launches"][k] for k in ("perm_put", "ring_shift")}
    ticks = st["ticks"] + (8 if act == "tiered" else 0)  # run_pressured's fill
    assert sorted(rec["tick_ms"]) == list(range(1, ticks + 1))
    assert len(rec["decode_ms"]) == ticks
    assert not obs_trace.active().enabled  # drive_act switched it off
    ex.check_tokens(act, _reference_tokens(models, reqs()), rec["tokens"])


# --------------------------------------------------------------------------- #
# the transport constants the cluster plans and prices with
# --------------------------------------------------------------------------- #
def test_cluster_on_the_cpu_keeps_the_references_costs(models):
    """On the CPU the cluster plans with the reference's constants, so its
    plans describe themselves as the reference's do; ``costs`` passed in
    still win."""
    assert _cluster(models).costs is sched.DEFAULT_COSTS
    mine = {"xla": sched.EngineCost(1.0, 2.0, 0.5)}
    assert _cluster(models, costs=mine).costs is mine


def test_measure_costs_fits_each_engine_from_timed_puts(monkeypatch):
    """``measure_costs`` times a put and the landing alone at each size
    through each engine, fits α and β from the puts and γ from the
    landings (``EngineCost.fit_from_trace``), and measures once per
    device, engines and sizes."""
    timed = []

    def fake(fn, device, reps):
        fn()  # the put or the landing runs on the CPU through each engine
        n = len(timed)
        timed.append(n)
        size_kib = (1, 16)[(n // 2) % 2]
        # put: 10 µs + 3 µs/KiB; landing alone: 1 µs/KiB
        return 10.0 + 3.0 * size_kib if n % 2 == 0 else 1.0 * size_kib

    monkeypatch.setattr(sched, "_timed_us", fake)
    monkeypatch.setattr(sched, "_MEASURED", {})
    costs = sched.measure_costs("cpu", ("gascore", "xla"),
                                sizes=(1 << 10, 1 << 14))
    assert len(timed) == 2 * 2 * 2  # engines x sizes x (put, landing)
    for name in ("xla", "gascore"):
        c = costs[name]
        assert c.alpha_us == pytest.approx(10.0)
        assert c.gamma_us_per_kib == pytest.approx(1.0)
        assert c.beta_us_per_kib == pytest.approx(2.0)
    again = sched.measure_costs("cpu", ["xla", "gascore"],
                                sizes=(1 << 10, 1 << 14))
    assert again == costs and len(timed) == 8


def test_measure_costs_runs_on_the_cpu():
    costs = sched.measure_costs("cpu", ("xla",), sizes=(1 << 10, 1 << 12),
                                reps=1)
    c = costs["xla"]
    assert min(c.alpha_us, c.beta_us_per_kib, c.gamma_us_per_kib) >= 0.0
    assert costs["gascore"] == sched.DEFAULT_COSTS["gascore"]


def test_annotating_tracer_names_profiler_ranges_after_its_spans():
    """``Tracer(annotate=cats)`` opens a profiler range ``cat::name`` for
    every scoped span of those categories (none for other categories,
    async spans or instants); a plain tracer opens none."""
    def names(tracer):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with tracer.span("tick", cat="tick"):
                with tracer.span("decode", cat="tick_phase"):
                    with tracer.span("decode_step", cat="decode"):
                        torch.ones(4).sum()
                tracer.instant("req_admit", cat="tick_phase")
                tracer.end_async(tracer.begin_async("put_nb", cat="tick_phase"))
        return {e.name for e in prof.events()}

    got = names(obs_trace.Tracer(annotate=("tick_phase",)))
    assert "tick_phase::decode" in got
    assert not {"tick::tick", "decode::decode_step", "tick_phase::req_admit",
                "tick_phase::put_nb"} & got
    assert not {n for n in names(obs_trace.Tracer()) if "::" in n and
                n.split("::")[0] in ("tick", "tick_phase", "decode")}
