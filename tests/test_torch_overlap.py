"""Split-phase transfers of the port on the CPU: handle semantics, the
cached index constants, and split-phase rings against blocking ones.

On the card a ``*_nb`` transfer runs on a side stream and completes
through a CUDA event (``tests/test_torch_kernels_cuda.py`` checks that);
on the CPU there is no stream, and everything here must behave exactly as
it did before split phase was real: the same values, the same errors,
the same completion order.  Rings are held bit for bit against the plain
versions of ``kernels/ref.py`` on numpy inputs from a seed.
"""

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.core import collectives, extended, gasnet
from repro_torch.core.engine import AlreadyWaitedError, wait_all
from repro_torch.kernels import ref

BACKENDS = ["xla", "gascore", "xla,gascore"]
N = 4


def _ctx(backend, n=N):
    return gasnet.Context(n, backend=backend, device="cpu")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _payload(seed, shape):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


# --------------------------------------------------------------------------- #
# Pending and handle semantics, unchanged on the CPU
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", BACKENDS)
def test_pending_waits_once_and_carries_no_event_on_cpu(backend):
    x = _payload(0, (N, 3))
    seen = {}

    def prog(node, v):
        p = node.engine.shift_nb(v[0], 1)
        q = node.engine.permute_nb(v[0], [1, 2, 3, 0])
        seen["events"] = (p.events, q.events)
        assert p.ready() and not p.waited
        a = p.wait()
        with pytest.raises(AlreadyWaitedError, match="shift"):
            p.wait()
        (b,) = wait_all([q])
        with pytest.raises(AlreadyWaitedError, match="#0 \\(permute\\)"):
            wait_all([q])
        return torch.stack([a, b])[None]

    out = _ctx(backend).spmd(prog, x)
    assert seen["events"] == ((), ())
    assert torch.equal(out[:, 0], ref.ring_shift(x, 1))
    assert torch.equal(out[:, 1], ref.perm_put(x, [1, 2, 3, 0]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_vectored_pendings_split_one_move(backend):
    x = _payload(1, (N, 10))

    def prog(node, v):
        ps = node.engine.shift_nbv([v[0, :3], v[0, 3:], v[0, :1]], 2)
        assert len({p.events for p in ps}) == 1  # one move for all
        return torch.cat([p.wait() for p in ps])[None]

    out = _ctx(backend).spmd(prog, x)
    want = ref.ring_shift(x, 2)
    assert torch.equal(out, torch.cat([want[:, :3], want[:, 3:],
                                       want[:, :1]], 1))


@pytest.mark.parametrize("backend", BACKENDS)
def test_sync_all_is_fifo_and_try_sync_returns_true(backend):
    n, S = N, 16
    seg = torch.zeros((n, S), dtype=torch.float32)
    data = _payload(2, (n, 4))

    def prog(node, s, d):
        h1 = node.put_nb(s, d[0], to=gasnet.Shift(1), index=2)
        h2 = node.get_nb(s, frm=gasnet.Shift(1), index=0, size=4)
        h3 = node.put_nb(s, d[0] * 2, to=gasnet.Shift(1), index=2)
        h4 = node.get_nb(s, frm=gasnet.Shift(2), index=1, size=3)
        ok, got4 = node.try_sync(h4)
        assert ok is True
        with pytest.raises(AlreadyWaitedError):
            node.sync(h4)
        seg1, got2, seg3 = node.sync_all()  # h1, h2, h3 in issue order
        with pytest.raises(AlreadyWaitedError):
            h1.complete()
        return seg1, got2[None], seg3, got4[None]  # segs are (1, S)

    seg1, got2, seg3, got4 = _ctx(backend).spmd(
        prog, seg, data, out_specs=(gasnet.P("node"),) * 4)
    # puts on one segment chain: the second lands over the first
    want = torch.zeros((n, S))
    want[:, 2:6] = ref.ring_shift(data, 1) * 2
    assert torch.equal(seg3.reshape(n, S), want)
    assert torch.equal(got2, torch.zeros((n, 4)))  # read the old segment
    assert got4.shape == (n, 3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_deferred_landing_completes_through_the_pendings(backend):
    n, S = N, 12
    seg = torch.full((n, S), -1.0)
    data = _payload(3, (n, 5))

    def prog(node, s, d):
        h = node.put_nb(s, d[0], to=gasnet.Perm((2, 3, 0, 1)), index=4,
                        pred=True)
        moved, offs, flags = node.defer(h)
        with pytest.raises(AlreadyWaitedError):
            node.defer(h)
        return moved[None], offs[None], flags[None]

    moved, offs, flags = _ctx(backend).spmd(
        prog, seg, data, out_specs=(gasnet.P("node"),) * 3)
    extended.land(seg, moved.reshape(n, 1, 5), offs.reshape(n, 1),
                  flags.reshape(n, 1))
    want = torch.full((n, S), -1.0)
    want[:, 4:9] = ref.perm_put(data, (2, 3, 0, 1))
    assert torch.equal(seg, want)


# --------------------------------------------------------------------------- #
# index constants: built once per destination list, never per call
# --------------------------------------------------------------------------- #
def test_index_constants_build_once_per_dst(monkeypatch):
    made = []
    real = compat._materialize

    def spy(values, dtype, device):
        made.append((values, dtype))
        return real(values, dtype, device)

    monkeypatch.setattr(compat, "_CONSTS", {})
    monkeypatch.setattr(compat, "_materialize", spy)
    x = _payload(4, (N, 6))
    dst = [3, 0, 1, 2]

    def prog(node, v):
        a = node.engine.permute_nb(v[0], dst).wait()
        b = node.engine.permute(v[0], dst)
        return (a + b)[None]

    outs = [_ctx("xla,gascore").spmd(prog, x) for _ in range(3)]
    first = list(made)
    assert first, "the permutation's constants were never built"
    assert len(first) == len(set(first))  # each once
    for _ in range(3):
        _ctx("xla,gascore").spmd(prog, x)
    assert made == first  # later calls and programs reuse them
    for o in outs:
        assert torch.equal(o, 2 * ref.perm_put(x, dst))


def test_as_i32_of_host_values_adds_no_cached_constant(monkeypatch):
    from repro_torch.core.indexing import as_i32

    made = []
    real = compat._materialize
    monkeypatch.setattr(compat, "_CONSTS", {})
    monkeypatch.setattr(compat, "_materialize",
                        lambda *a: made.append(a[0]) or real(*a))
    a = as_i32([5, 7, 9], torch.device("cpu"))
    b = as_i32((5, 7, 9), torch.device("cpu"))
    c = as_i32(np.array([[5, 7, 9]]), torch.device("cpu"))
    s = as_i32(11, torch.device("cpu"))
    for t in (a, b, c):
        assert t.dtype == torch.int32 and t.reshape(-1).tolist() == [5, 7, 9]
    assert c.shape == (1, 3)
    assert s.dtype == torch.int32 and int(s) == 11 and s.dim() == 0
    assert made == [] and compat._CONSTS == {}


@pytest.mark.parametrize("backend", BACKENDS)
def test_distinct_index_lists_leave_the_constant_cache_bounded(
        monkeypatch, backend):
    """Caller-chosen index lists (a vectored get's page offsets) are not
    cached: many distinct lists leave the constant cache as one call did."""
    monkeypatch.setattr(compat, "_CONSTS", {})
    S = 16
    seg = _payload(7, (N, S))
    ctx = _ctx(backend)
    sizes = []
    for i in range(24):
        idx = [(i + 5 * j) % (S - 1) for j in range(3)]

        def prog(node, s, idx=idx):
            return node.get_v(s, frm=gasnet.Shift(1), indices=idx,
                              size=2).reshape(1, -1)

        out = ctx.spmd(prog, seg)
        want = torch.stack([torch.cat([seg[(r + 1) % N, k:k + 2] for k in idx])
                            for r in range(N)])
        assert torch.equal(out, want)
        sizes.append(len(compat._CONSTS))
    assert sizes == [sizes[0]] * len(sizes)


# --------------------------------------------------------------------------- #
# split-phase rings == blocking rings == the plain versions, bit for bit
# --------------------------------------------------------------------------- #
def _blocking_reduce_scatter(engine, x):
    """The ring reduce-scatter on BLOCKING shifts: every hop's put is
    complete before its add (no split phase)."""
    n = engine.n_nodes
    blocks = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
    me = engine.my_id()
    cur = collectives.take(blocks, torch.remainder(me - 1 + n, n))
    for h in range(1, n):
        c = torch.remainder(me - h - 1 + 2 * n, n)
        cur = engine.shift(cur, 1) + collectives.take(blocks, c)
    return cur


def _blocking_all_gather(engine, x):
    n = engine.n_nodes
    me = engine.my_id()
    out = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype)
    out = collectives.dynamic_update_slice(out, x[None], me)
    cur = x
    for k in range(1, n):
        cur = engine.shift(cur, 1)
        out = collectives.dynamic_update_slice(
            out, cur[None], torch.remainder(me - k + n, n))
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n_segments,depth", [(1, 1), (3, 2), (5, 3)])
def test_split_phase_rings_equal_blocking_rings_and_plain(backend,
                                                          n_segments, depth):
    n, m, w = N, 6, 8
    x = _payload(5 + n_segments, (n, n * m, w))
    want_rs = ref.reduce_scatter(x)
    want_ar = ref.all_gather(want_rs).reshape(n, n * m, w)
    ctx = _ctx(backend)

    def run(fn):
        return ctx.spmd(lambda node, v: fn(node.engine, v[0])[None], x)

    blocking = run(lambda e, v: _blocking_all_gather(
        e, _blocking_reduce_scatter(e, v)))
    split = run(collectives.ring_all_reduce)
    segmented = run(lambda e, v: collectives.segmented_ring_all_reduce(
        e, v, n_segments=n_segments, depth=depth))
    rs = run(lambda e, v: collectives.segmented_ring_reduce_scatter(
        e, v, n_segments=n_segments, depth=depth))
    exchanged = run(collectives.exchange)
    assert torch.equal(_bits(rs), _bits(want_rs))
    for got in (blocking, split, segmented):
        assert torch.equal(_bits(got), _bits(want_ar))
    assert torch.equal(exchanged, ref.all_to_all(x))


@pytest.mark.parametrize("backend", BACKENDS)
def test_split_phase_broadcast_and_recursive_doubling(backend):
    x = _payload(9, (N, 5))

    def run(fn):
        return _ctx(backend).spmd(lambda node, v: fn(node.engine, v[0])[None], x)

    assert torch.equal(run(lambda e, v: collectives.broadcast(e, v, root=2)),
                       x[2].expand(N, 5))
    rd = run(collectives.recursive_doubling_all_reduce)
    assert torch.equal(rd[0], rd[3])
    torch.testing.assert_close(rd[0], x.sum(0), rtol=1e-6, atol=1e-6)
