"""The port's GAS substrate against the JAX reference, on the CPU.

Collectives run on the port's three backends (``xla``, ``gascore`` and the
mixed ``xla,gascore`` map, all ranks stacked on the CPU) and on the
reference's lockstep simulator, on the same numpy inputs: bit for bit.
The planner must describe the same plans.  The Extended API handle
mechanics, the handle-misuse errors and the engine/spec cases of the
reference's tests are mirrored here.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collectives as jcoll
from repro.core import engine as jengine
from repro.core import sched as jsched
from repro.testing.sim import run_spmd as jrun_spmd
from repro_torch.core import collectives, extended, gasnet, sched, transport
from repro_torch.core.addrspace import AddressSpace, GlobalAddress
from repro_torch.core.engine import (
    AlreadyWaitedError,
    EngineMap,
    GascoreEngine,
    Pending,
    XlaEngine,
    make_engine,
    parse_backend_spec,
    wait_all,
)
from repro_torch.core.gasnet import P
from repro_torch.launch.mesh import node_backends
from repro_torch.testing.sim import run_spmd

BACKENDS = ["xla", "gascore", "xla,gascore"]


def _ctx(n, backend, **kw):
    return gasnet.Context(n, backend=backend, device="cpu", **kw)


def _port(n, backend, fn, x):
    """``fn(engine, local)`` on every rank of the port; returns the
    rank-stacked (n, ...) result as numpy."""
    out = _ctx(n, backend).spmd(
        lambda node, v: fn(node.engine, node.local(v))[None],
        torch.from_numpy(x.copy()),
    )
    return out.numpy()


def _ref(n, fn, x):
    outs = jrun_spmd(lambda e: fn(e, jnp.asarray(x[e.rank])), n)
    return np.stack([np.asarray(o) for o in outs])


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


# (name, port fn, reference fn, rows per rank as a multiple of n)
RINGS = [
    ("all_gather", collectives.ring_all_gather, jcoll.ring_all_gather, 0),
    ("reduce_scatter", collectives.ring_reduce_scatter,
     jcoll.ring_reduce_scatter, 2),
    ("all_reduce", collectives.ring_all_reduce, jcoll.ring_all_reduce, 2),
    ("all_reduce_fallback", collectives.ring_all_reduce,
     jcoll.ring_all_reduce, -1),
    ("broadcast", lambda e, v: collectives.broadcast(e, v, root=1),
     lambda e, v: jcoll.broadcast(e, v, root=1), 0),
    ("exchange", collectives.exchange, jcoll.exchange, 2),
    ("seg_all_gather",
     lambda e, v: collectives.segmented_ring_all_gather(
         e, v, n_segments=3, depth=2),
     lambda e, v: jcoll.segmented_ring_all_gather(
         e, v, n_segments=3, depth=2), 0),
    ("seg_reduce_scatter",
     lambda e, v: collectives.segmented_ring_reduce_scatter(
         e, v, n_segments=3, depth=2),
     lambda e, v: jcoll.segmented_ring_reduce_scatter(
         e, v, n_segments=3, depth=2), 3),
    ("seg_all_reduce",
     lambda e, v: collectives.segmented_ring_all_reduce(
         e, v, n_segments=2, depth=3),
     lambda e, v: jcoll.segmented_ring_all_reduce(
         e, v, n_segments=2, depth=3), 2),
    ("recursive_doubling", collectives.recursive_doubling_all_reduce,
     jcoll.recursive_doubling_all_reduce, 1),
]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("case", RINGS, ids=[c[0] for c in RINGS])
def test_collectives_bit_exact_against_reference(case, n, backend):
    """Random f32 through the same hop and accumulate order: the port's
    engines and the reference's simulator agree bit for bit."""
    _, port_fn, ref_fn, mult = case
    rows = 3 if mult == 0 else (5 if mult < 0 else mult * n)
    x = np.random.default_rng(n).normal(size=(n, rows, 4)).astype(np.float32)
    _same(_port(n, backend, port_fn, x), _ref(n, ref_fn, x))


def test_tree_broadcast_on_software_nodes_only():
    n = 8
    x = np.random.default_rng(0).normal(size=(n, 3, 2)).astype(np.float32)
    tree = lambda e, v: collectives.tree_broadcast(e, v, root=3)  # noqa: E731
    _same(_port(n, "xla", tree, x),
          _ref(n, lambda e, v: jcoll.tree_broadcast(e, v, root=3), x))
    with pytest.raises(ValueError, match="partial permute"):
        _port(n, "gascore", tree, x)


PLANNED = [
    ("all_reduce", sched.all_reduce, jsched.all_reduce, 1),
    ("all_gather", sched.all_gather, jsched.all_gather, 0),
    ("reduce_scatter", sched.reduce_scatter, jsched.reduce_scatter, 1),
    ("broadcast", lambda e, v: sched.broadcast(e, v, root=2),
     lambda e, v: jsched.broadcast(e, v, root=2), 0),
    ("all_to_all", sched.all_to_all, jsched.all_to_all, 1),
]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("case", PLANNED, ids=[c[0] for c in PLANNED])
def test_planned_collectives_match_reference(case, n, backend):
    """Planned execution picks per engine (native vs direct, tree vs ring),
    so int32 data makes every algorithm's result exact."""
    _, port_fn, ref_fn, mult = case
    rows = 3 if mult == 0 else 2 * n
    x = np.random.default_rng(n + 1).integers(-99, 99, size=(n, rows, 4)
                                              ).astype(np.int32)
    _same(_port(n, backend, port_fn, x), _ref(n, ref_fn, x))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("op", ["all_gather", "reduce_scatter", "all_reduce",
                                "all_to_all"])
def test_engine_native_collectives(op, backend):
    """The engines' own collectives (the GAScore's fused ring kernels,
    the software node's indexing) against the reference's rings; the
    gascore reduce-scatter and all-reduce keep the ring's f32 bits."""
    n = 4
    rng = np.random.default_rng(5)
    xi = rng.integers(-99, 99, size=(n, 2 * n, 3)).astype(np.int32)
    ref_fn = {"all_gather": jcoll.ring_all_gather,
              "reduce_scatter": jcoll.ring_reduce_scatter,
              "all_reduce": jcoll.ring_all_reduce,
              "all_to_all": jcoll.exchange}[op]
    port_fn = lambda e, v: getattr(e, op)(v)  # noqa: E731
    _same(_port(n, backend, port_fn, xi), _ref(n, ref_fn, xi))
    if op in ("reduce_scatter", "all_reduce") and backend != "xla":
        xf = rng.normal(size=(n, 2 * n, 3)).astype(np.float32)
        _same(_port(n, backend, port_fn, xf), _ref(n, ref_fn, xf))


def test_gascore_all_reduce_ragged_falls_back_to_shift_ring():
    n = 4
    x = np.random.default_rng(2).normal(size=(n, 3)).astype(np.float32)
    _same(_port(n, "gascore", lambda e, v: e.all_reduce(v), x),
          _ref(n, jcoll.ring_all_reduce, x))


def test_port_simulator_matches_reference_simulator():
    n = 4
    x = np.random.default_rng(3).normal(size=(n, 2 * n, 3)).astype(np.float32)
    outs = run_spmd(
        lambda e: collectives.segmented_ring_all_reduce(
            e, torch.from_numpy(x[e.rank].copy()), n_segments=2), n)
    _same(np.stack([o.numpy() for o in outs]),
          _ref(n, lambda e, v: jcoll.segmented_ring_all_reduce(
              e, v, n_segments=2), x))


def test_transport_ops_raise_outside_spmd():
    x, ids = torch.zeros((2, 3)), torch.arange(2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="Context.spmd"):
        transport.shift(x, ids, 1, 2, "gascore")
    with pytest.raises(RuntimeError, match="no rank ids"):
        XlaEngine("node", 2).shift(x, 1)


# --------------------------------------------------------------------------- #
# the planner: describe() equals the reference's
# --------------------------------------------------------------------------- #
def _engines(n):
    yield "none", None, None
    yield "xla", XlaEngine("node", n), jengine.XlaEngine("node", n)
    yield "gascore", GascoreEngine("node", n), jengine.GascoreEngine("node", n)
    if n % 2 == 0:
        b = parse_backend_spec("xla,gascore", n)
        yield "map", EngineMap("node", b), jengine.EngineMap("node", b)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_plan_describe_equals_reference(n):
    for name, pe, je in _engines(n):
        for op in ("all_reduce", "all_gather", "reduce_scatter", "broadcast",
                   "all_to_all"):
            for nbytes in (1 << 10, 1 << 20, 1 << 24):
                got = sched.plan_collective(op, nbytes=nbytes, n_nodes=n,
                                            engine=pe)
                want = jsched.plan_collective(op, nbytes=nbytes, n_nodes=n,
                                              engine=je)
                assert got.describe() == want.describe(), (name, op, nbytes)
                assert got == jsched.CollectivePlan(**vars(want)) or (
                    got.describe() == want.describe())
        for nbytes in (1 << 10, 1 << 20, 8 << 20):
            assert sched.plan_p2p(nbytes=nbytes, engine=pe).describe() == (
                jsched.plan_p2p(nbytes=nbytes, engine=je).describe())


def test_fit_from_trace_matches_reference():
    spans = [{"bytes": b, "dur_us": 30.0 + 0.4 * b / 1024}
             for b in (1024, 65536, 1 << 20)]
    epi = [{"bytes": b, "dur_us": 2.0 + 0.1 * b / 1024}
           for b in (1024, 1 << 20)]
    got = sched.EngineCost.fit_from_trace(spans, epilogue_spans=epi)
    want = jsched.EngineCost.fit_from_trace(spans, epilogue_spans=epi)
    assert (got.alpha_us, got.beta_us_per_kib, got.gamma_us_per_kib) == (
        want.alpha_us, want.beta_us_per_kib, want.gamma_us_per_kib)
    assert got.model_error(spans) == want.model_error(spans)
    cost, note = sched.try_fit_from_trace(spans[:1])
    assert cost is None and note.startswith("fit: insufficient-data")


def test_load_costs_and_pair_costs(tmp_path):
    path = tmp_path / "BENCH_gas.json"
    path.write_text(json.dumps({
        "engine_costs": {"xla": {"alpha_us": 7.0, "beta_us_per_kib": 0.5,
                                 "gamma_us_per_kib": 0.25}},
        "engine_pair_costs": {
            "xla->gascore": {"alpha_us": 100.0, "beta_us_per_kib": 2.0},
            "gascore->xla": {"alpha_us": 90.0, "beta_us_per_kib": 3.0},
        },
    }))
    costs = sched.load_costs(str(path))
    assert costs["xla"].alpha_us == 7.0 and "gascore" in costs
    m = EngineMap("node", ("xla", "gascore"))
    c = sched.cost_of(m, costs)
    assert c.alpha_us == 100.0 and c.beta_us_per_kib == 3.0
    assert sched.load_costs(str(tmp_path / "nope.json")) == sched.DEFAULT_COSTS
    homog = EngineMap("node", ("xla", "xla"))
    assert sched.cost_of(homog, costs).alpha_us == 7.0


# --------------------------------------------------------------------------- #
# engines and specs (mirrors tests/test_sched.py)
# --------------------------------------------------------------------------- #
def test_parse_backend_spec_and_make_engine():
    assert parse_backend_spec("xla", 4) == ("xla",) * 4
    assert parse_backend_spec("xla,gascore", 4) == (
        "xla", "gascore", "xla", "gascore")
    assert parse_backend_spec(["gascore", "xla"], 2) == ("gascore", "xla")
    for bad in ("xla,gascore,xla", ""):
        with pytest.raises(ValueError):
            parse_backend_spec(bad, 4)
    assert isinstance(make_engine("xla", "node", 4), XlaEngine)
    assert isinstance(make_engine("gascore,gascore", "node", 4), GascoreEngine)
    m = make_engine("xla,gascore", "node", 4)
    assert isinstance(m, EngineMap) and m.is_heterogeneous
    assert m.backend_of(0) == "xla" and m.backend_of(1) == "gascore"
    assert not m.can_permute_partial
    assert EngineMap("node", ("xla", "xla")).can_permute_partial
    with pytest.raises(ValueError, match="unknown engine"):
        make_engine("fpga", "node", 2)


def test_node_backends_patterns():
    assert node_backends(4) == ("xla",) * 4
    assert node_backends(4, pattern="alternating") == (
        "xla", "gascore", "xla", "gascore")
    assert node_backends(4, pattern="split") == (
        "xla", "xla", "gascore", "gascore")
    assert node_backends(4, hw_ranks=[0]) == ("gascore", "xla", "xla", "xla")
    with pytest.raises(ValueError):
        node_backends(4, hw_ranks=[0], pattern="split")
    with pytest.raises(ValueError):
        node_backends(4, pattern="zebra")


def test_pending_and_wait_all():
    p = Pending(torch.ones(3), op="shift(k=2)")
    p.wait()
    with pytest.raises(AlreadyWaitedError, match=r"shift\(k=2\)"):
        p.wait()
    p1, p2 = Pending(torch.ones(2), op="shift(k=1)"), Pending(torch.ones(2),
                                                             op="permute")
    p1.wait()
    with pytest.raises(AlreadyWaitedError, match=r"#0 \(shift\(k=1\)\)"):
        wait_all([p1, p2])
    assert not p2.waited and len(wait_all([p2])) == 1
    h = extended.GetHandle(torch.zeros(1))
    h.complete()
    with pytest.raises(AlreadyWaitedError, match="get"):
        h.complete()


def test_segment_bounds_partition_exactly():
    for m in (1, 2, 7, 16, 33):
        for g in (1, 2, 3, 8, 64):
            b = collectives.segment_bounds(m, g)
            assert b == jcoll.segment_bounds(m, g)


# --------------------------------------------------------------------------- #
# address space (mirrors tests/test_addrspace.py, less its mesh cases)
# --------------------------------------------------------------------------- #
def test_address_space_register_alloc_read():
    aspace = AddressSpace(2, "cpu")
    spec = aspace.register("seg", (8, 4), torch.float32)
    assert spec.local_size == 32 and spec.global_shape(2) == (2, 8, 4)
    seg = aspace.alloc("seg", init_fn=torch.ones)
    assert seg.shape == (2, 8, 4) and seg.device.type == "cpu"
    got = aspace.read(seg, GlobalAddress(node=1, index=3), length=5)
    assert got.shape == (5,) and got.eq(1).all()
    with pytest.raises(ValueError):
        aspace.register("seg", (4,))
    aspace.register("small", (4,))
    with pytest.raises(ValueError):
        aspace.alloc_from("small", torch.zeros((2, 5)))
    assert aspace.alloc_from("small", torch.ones((2, 4), dtype=torch.int32)
                             ).dtype == torch.float32
    assert aspace.in_specs() == P("node")


# --------------------------------------------------------------------------- #
# Extended API (mirrors tests/test_extended.py and test_handle_misuse.py)
# --------------------------------------------------------------------------- #
def test_put_handle_lands_payload_at_offset_or_not():
    h = extended.PutHandle(torch.zeros(8), moved=torch.tensor([1.0, 2.0]),
                           midx=torch.tensor(3, dtype=torch.int32),
                           received=torch.tensor(True), restore=lambda x: x)
    assert h.complete().tolist() == [0, 0, 0, 1, 2, 0, 0, 0]
    h = extended.PutHandle(torch.ones(4), moved=torch.tensor([9.0]),
                           midx=torch.tensor(0, dtype=torch.int32),
                           received=torch.tensor(False), restore=lambda x: x)
    assert h.complete().eq(1).all()


def _seg(ctx, n_el=8, init=torch.zeros):
    aspace = ctx.address_space()
    aspace.register("buf", (n_el,), torch.float32)
    return aspace.alloc("buf", init_fn=init)


@pytest.mark.parametrize("backend", BACKENDS)
def test_outstanding_puts_compose_and_blocking_ones_do_not(backend):
    ctx = _ctx(2, backend)
    seg = _seg(ctx)

    def prog(node, seg):
        h1 = node.put_nb(seg, torch.full((2,), 1.0), index=0)
        h2 = node.put_nb(seg, torch.full((2,), 2.0), index=4)
        seg = node.sync(h1)
        return node.sync(h2)

    assert ctx.spmd(prog, seg)[0].tolist() == [1, 1, 0, 0, 2, 2, 0, 0]

    def prog_all(node, seg):
        node.put_nb(seg, torch.full((2,), 3.0), index=0)
        node.put_nb(seg, torch.full((2,), 4.0), index=2)
        node.put_nb(seg, torch.full((2,), 5.0), index=4)
        return node.sync_all()[-1]

    assert ctx.spmd(prog_all, seg)[1].tolist() == [3, 3, 4, 4, 5, 5, 0, 0]

    def prog_blocking(node, seg):
        a = node.put(seg, torch.full((2,), 1.0), index=0)
        b = node.put(seg, torch.full((2,), 2.0), index=2)
        return a, b

    a, b = ctx.spmd(prog_blocking, seg, out_specs=(P("node"), P("node")))
    assert a[0].tolist()[:4] == [1, 1, 0, 0] and b[0].tolist()[:4] == [0, 0, 2, 2]


@pytest.mark.parametrize("backend", BACKENDS)
def test_handle_misuse_raises(backend):
    ctx = _ctx(2, backend)
    seg = _seg(ctx, 16, torch.ones)

    def prog(node, seg):
        h = node.put_nb(seg, torch.full((2,), 5.0), index=0)
        done, seg2 = node.try_sync(h)
        assert done
        with pytest.raises(AlreadyWaitedError, match="already synced"):
            node.sync(h)
        g = node.get_nb(seg, index=4, size=2)
        node.try_sync(g)
        with pytest.raises(AlreadyWaitedError, match="already synced"):
            node.sync(g)
        hp = node.put_nb(seg, torch.full((2,), 3.0), index=8)
        node.get_nb(seg, index=8, size=2)
        first = node.sync_all()
        assert len(first) == 2 and node.sync_all() == []
        with pytest.raises(AlreadyWaitedError, match="already synced"):
            node.sync(hp)
        hv = node.put_nbv(seg2, torch.arange(4.0).reshape(2, 2),
                          indices=[0, 8])
        seg3 = node.sync(hv)
        with pytest.raises(AlreadyWaitedError, match="already synced"):
            node.sync(hv)
        gv = node.get_nbv(seg3, indices=[0, 4], size=2)
        got = node.sync(gv)
        with pytest.raises(AlreadyWaitedError, match="already synced"):
            node.sync(gv)
        return seg3, got[None]

    seg3, got = ctx.spmd(prog, seg, out_specs=(P("node"), P("node")))
    assert seg3[0, :2].tolist() == [0.0, 1.0] and seg3[0, 8:10].tolist() == [
        2.0, 3.0]
    assert got.shape == (2, 2, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backend", BACKENDS)
def test_vectored_puts_gets_and_pred(backend, dtype):
    """put_nbv's command block rides the f32 carrier bitcast (one
    initiation) or its own initiation for bf16; per-payload and per-rank
    predicates gate the writes; get_nbv and pred-gated gets."""
    n = 4
    ctx = _ctx(n, backend)
    aspace = ctx.address_space()
    aspace.register("buf", (16,), dtype)
    seg = aspace.alloc("buf")

    def prog(node, seg):
        me = node.my_id
        datas = torch.stack([torch.full((2,), 1.0) + me,
                             torch.full((2,), 10.0) + me]).to(dtype)
        seg = node.put_v(seg, datas, to=gasnet.Shift(1), indices=[2, 9],
                         pred=[True, False])
        seg = node.put(seg, torch.full((3,), 7.0), to=gasnet.Perm(
            (1, 2, 3, 0)), index=12, pred=me % 2 == 0)
        got = node.get_v(seg, frm=gasnet.Shift(1), indices=[2, 12], size=2,
                         pred=me != 3)
        return seg, got[None]

    seg, got = ctx.spmd(prog, seg, out_specs=(P("node"), P("node")))
    s = seg.float().numpy()
    for d in range(n):
        src = (d - 1) % n
        assert s[d, 2:4].tolist() == [1.0 + src] * 2
        assert not s[d, 9:11].any()  # flag cleared: untouched
        assert s[d, 12:15].tolist() == ([7.0] * 3 if src % 2 == 0 else [0.0] * 3)
    g = got.float().numpy()
    for r in range(n):
        if r == 3:
            assert not g[r].any()
        else:
            assert g[r, 0].tolist() == s[(r + 1) % n, 2:4].tolist()
            assert g[r, 1].tolist() == s[(r + 1) % n, 12:14].tolist()


@pytest.mark.parametrize("backend", BACKENDS)
def test_active_messages_long_and_request_reply(backend):
    n = 4
    ctx = _ctx(n, backend, am_payload_width=4, am_capacity=4)
    ctx.handlers.register("write", gasnet.am_lib.long_write_handler("seg"))
    pong = ctx.handlers.register(
        "pong", lambda st, p, a: dict(st, acks=st["acks"] + a[0]))

    def ping(st, payload, args):
        st = dict(st, pings=st["pings"] + 1)
        return st, gasnet.am_lib.reply_short(pong, (args[0] * 10,),
                                             like=payload)

    ctx.handlers.register("ping", ping, replies=True)
    seg = _seg(ctx, 12)

    def prog(node, seg):
        me = node.my_id
        dest = ((me + 1) % n).to(torch.int32)
        node.am_long(dest, "write", torch.full((4,), 5.0) + me, dst_index=3,
                     nelem=2)
        h = node.am_call(dest, "ping", args=(me + 1,),
                         ack=lambda st: st["acks"])
        st = {"seg": node.local(seg), "pings": torch.zeros((), dtype=torch.int32),
              "acks": torch.zeros((), dtype=torch.int32)}
        st = node.am_flush(st)
        return st["seg"][None], st["pings"][None], node.sync(h)[None]

    s, pings, acks = ctx.spmd(prog, seg, out_specs=(P("node"),) * 3)
    for d in range(n):
        src = (d - 1) % n
        assert s[d, 3:5].tolist() == [5.0 + src] * 2 and not s[d, 5:].any()
    assert pings.tolist() == [1] * n
    assert acks.tolist() == [10 * (r + 1) for r in range(n)]
    with pytest.raises(ValueError, match="not a replying handler"):
        ctx.spmd(lambda node, seg: node.am_call(
            torch.tensor(0, dtype=torch.int32), "write") or seg, seg)


def test_rma_am_and_plan_spans_reach_the_port_tracer():
    """With tracing on, split-phase ops ride an async span from initiation
    to sync, AM flushes and routes are recorded, and each plan leaves an
    instant with its predicted cost."""
    from repro_torch.obs import trace

    tr = trace.enable()
    try:
        ctx = _ctx(4, "xla,gascore", am_payload_width=2)
        ctx.handlers.register("nop", lambda st, p, a: st)
        seg = _seg(ctx, 8)

        def prog(node, seg):
            seg = node.put(seg, torch.ones(2), index=0)
            node.get(seg, index=0, size=2)
            node.put_v(seg, torch.ones((2, 2)), indices=[0, 4])
            node.get_v(seg, indices=[0, 4], size=2)
            node.am_short(torch.tensor(0, dtype=torch.int32), "nop")
            node.am_flush({"x": torch.zeros(())})
            sched.all_reduce(node.engine, node.local(seg))
            return seg

        ctx.spmd(prog, seg)
    finally:
        trace.disable()
    rma = {s.name: s for s in tr.spans(cat="rma")}
    assert set(rma) == {"put_nb", "get_nb", "put_nbv", "get_nbv"}
    assert rma["put_nb"].args["bytes"] == 2 * 4
    assert rma["put_nbv"].args["m"] == 2 and rma["put_nbv"].args["bytes"] == 16
    assert {s.name for s in tr.spans(cat="am")} >= {"am_flush", "am_route"}
    plans = list(tr.spans(cat="plan"))
    assert plans and {p.args["op"] for p in plans} >= {"all_reduce", "all_to_all"}
