"""The port's KV carrier and paged pool against the JAX reference.

The carrier must be bit-exact: the same cache bits (NaN payloads and
int32 positions bitcast into f32 included) give the same carrier bytes in
both packages, column for column.  The allocator and the store are host
bookkeeping: the same operation sequences must leave identical tables,
free lists, refcounts, prefix indexes and page bytes.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serving import kv as jkv
from repro.serving import pool as jpool
from repro_torch.compat import TensorSpec, tree_leaves
from repro_torch.serving import kv, pool

TORCH_DTYPE = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(ml_dtypes.bfloat16): torch.bfloat16,
}


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.contiguous().numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _serving_cache(seed, L, W, KH, dh, dtype):
    """A serving cache of raw random bits: payload leaves of ``dtype``
    (NaNs and denormals included) and int32 positions."""
    rng = np.random.default_rng(seed)
    nbits = 16 if dtype == ml_dtypes.bfloat16 else 32
    lo, hi = -(2 ** (nbits - 1)), 2 ** (nbits - 1) - 1
    itype = np.int16 if nbits == 16 else np.int32

    def raw(shape):
        x = rng.integers(lo, hi, size=shape, dtype=np.int64).astype(itype).view(dtype)
        if nbits == 16:
            # narrowing f32 -> bf16 quiets NaN payloads in both packages:
            # a bf16 cache holds no NaN bit patterns to preserve
            x[np.isnan(x.astype(np.float32))] = 0
        return x

    return [{"b0_global": {"attn": {
        "v": raw((L, 1, W, KH, dh)),
        "k": raw((L, 1, W, KH, dh)),
        "pos": rng.integers(-(2**31), 2**31 - 1, size=(L, 1, W),
                            dtype=np.int64).astype(np.int32),
    }}}]


def _layouts(cache, W, pt):
    jstruct = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), cache)
    tstruct = [{"b0_global": {"attn": {
        k: TensorSpec(v.shape, TORCH_DTYPE[v.dtype])
        for k, v in cache[0]["b0_global"]["attn"].items()
    }}}]
    return (
        jpool.PagedLayout.from_struct(jstruct, cache_len=W, page_tokens=pt),
        pool.PagedLayout.from_struct(tstruct, cache_len=W, page_tokens=pt),
    )


@settings(max_examples=20, deadline=None, database=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    pt=st.sampled_from([2, 4]),
    n_pages=st.integers(1, 3),
    bf16=st.booleans(),
)
def test_carrier_bit_exact_against_reference(seed, pt, n_pages, bf16):
    L, KH, dh = 2, 3, 5
    W = pt * n_pages
    if W in (L, KH, dh):
        W = pt * (n_pages + 4)  # keep the token axis unambiguous
    dtype = ml_dtypes.bfloat16 if bf16 else np.float32
    cache = _serving_cache(seed, L, W, KH, dh, dtype)
    jl, tl = _layouts(cache, W, pt)
    # same leaf order (sorted keys: k, pos, v) and column offsets
    assert [(s.offset, s.size, s.axis, s.fill) for s in jl.leaves] == [
        (s.offset, s.size, s.axis, s.fill) for s in tl.leaves
    ]
    assert jl.page_elems == tl.page_elems
    assert _bits(jl.empty_page_row()) == _bits(tl.empty_page_row())
    tcache = [{"b0_global": {"attn": {
        k: _to_torch(v) for k, v in cache[0]["b0_global"]["attn"].items()
    }}}]
    jpages = jl.flatten(jax.tree.map(jnp.asarray, cache))
    tpages = tl.flatten(tcache)
    assert _bits(jpages) == _bits(tpages)
    assert _bits(jl.flatten_page(cache, n_pages - 1)) == _bits(
        tl.flatten_page(tcache, n_pages - 1)
    )
    for a, b in zip(tree_leaves(tl.unflatten(tpages)), tree_leaves(tcache)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
    # a pool with a scratch row: decode views and back, bit for bit
    mem = np.concatenate([np.asarray(jpages), np.asarray(jpages)[:1]])
    jv = jl.decode_views(jnp.asarray(mem))
    tv = tl.decode_views(torch.from_numpy(mem.copy()))
    for a, b in zip(jax.tree.leaves(jv), tree_leaves(tv)):
        assert tuple(a.shape) == tuple(b.shape) and _bits(a) == _bits(b)
        assert b.is_contiguous()
    assert _bits(tl.views_to_pool(tv)) == mem.tobytes()


def test_kv_layout_and_carrier_casts_match_reference():
    rng = np.random.default_rng(0)
    bits = rng.integers(-(2**31), 2**31 - 1, size=(3, 4), dtype=np.int64)
    ints = bits.astype(np.int32)
    tree = {"b": ints, "a": ints.view(np.float32),
            "c": (bits.astype(np.int16)).view(ml_dtypes.bfloat16)}
    jl = jkv.KVLayout.from_struct(
        jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)
    )
    tl = kv.KVLayout.from_struct(
        {k: TensorSpec(v.shape, TORCH_DTYPE[v.dtype]) for k, v in tree.items()}
    )
    ttree = {k: _to_torch(v) for k, v in tree.items()}
    flat = tl.flatten(ttree)
    assert _bits(flat) == _bits(jl.flatten(jax.tree.map(jnp.asarray, tree)))
    back = tl.unflatten(flat)
    for k in tree:
        assert _bits(back[k]) == _bits(ttree[k])
    # int32 leaves ride the carrier as their bits, never as converted values
    assert _bits(kv.carrier_cast(ttree["b"])) == ints.tobytes()
    with pytest.raises(TypeError):
        kv.carrier_cast(torch.zeros(2, dtype=torch.complex64))


@settings(max_examples=40, deadline=None, database=None)
@given(
    n_pages=st.integers(1, 12),
    ops=st.lists(
        st.tuples(st.sampled_from(["alloc", "free", "fork", "cow"]),
                  st.integers(0, 2**31 - 1)),
        max_size=40,
    ),
)
def test_allocator_matches_reference_op_for_op(n_pages, ops):
    states = [jpool.make_pool(n_pages), pool.make_pool(n_pages)]
    mods = [jpool, pool]
    refs = []
    for op, r in ops:
        if op == "alloc":
            k = r % (states[0].n_free + 1)
            out = [m.alloc(s, k) for m, s in zip(mods, states)]
            assert out[0][1] == out[1][1]
            states = [o[0] for o in out]
            refs.extend(out[0][1])
        elif op == "free" and refs:
            k = r % len(refs) + 1
            drop = [refs.pop(r % len(refs)) for _ in range(k)]
            states = [m.free(s, drop) for m, s in zip(mods, states)]
        elif op == "fork" and refs:
            page = refs[r % len(refs)]
            states = [m.fork(s, (page,)) for m, s in zip(mods, states)]
            refs.append(page)
        elif op == "cow" and refs:
            i = r % len(refs)
            if states[0].refcnt[refs[i]] > 1 and states[0].n_free == 0:
                for m, s in zip(mods, states):
                    with pytest.raises(m.OutOfPagesError):
                        m.writable(s, refs[i])
            else:
                out = [m.writable(s, refs[i]) for m, s in zip(mods, states)]
                assert out[0][1:] == out[1][1:]
                states = [o[0] for o in out]
                refs[i] = out[0][1]
        assert (states[0].free, states[0].refcnt) == (
            states[1].free, states[1].refcnt
        )
        pool.check_pool(states[1])


_STORE_OPS = st.lists(
    st.tuples(
        st.sampled_from(["admit", "write", "release", "evict", "resume",
                         "materialize"]),
        st.integers(0, 2**31 - 1),
    ),
    max_size=30,
)


@settings(max_examples=25, deadline=None, database=None)
@given(n_pages=st.integers(4, 10), ops=_STORE_OPS, seed=st.integers(0, 99))
def test_store_matches_reference_op_for_op(n_pages, ops, seed):
    """Prefix-shared lazy admissions, decode writes (materialisation and
    copy-on-write), release, eviction and resume on both stores: every
    table, free list, refcount, prefix entry and page byte agrees."""
    W, pt = 12, 4
    cache = _serving_cache(seed, 1, W, 1, 2, np.float32)
    jl, tl = _layouts(cache, W, pt)
    stores = [jpool.PagedKVStore(jl, n_pages), pool.PagedKVStore(tl, n_pages)]
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 3, size=8).tolist()
    live, evicted, next_rid = {}, {}, 0

    def both(fn):
        outs = []
        for s, m in zip(stores, (jpool, pool)):
            try:
                outs.append(("ok", fn(s)))
            except m.OutOfPagesError:
                outs.append(("oom", None))
        assert outs[0] == outs[1]
        return outs[0]

    for op, r in ops:
        if op == "admit":
            n = 1 + r % 9
            prompt = (shared + rng.integers(0, 3, size=8).tolist())[:n] if r % 2 \
                else rng.integers(0, 3, size=n).tolist()
            lazy = bool(r % 3)
            # an eager admission backs every page of the table, not only
            # the prompt's
            if stores[0].n_free < (tl.pages_for(n) if lazy else tl.n_pages):
                continue
            plans = [s.plan_admit(prompt, lazy=lazy) for s in stores]
            assert (plans[0].table, plans[0].fresh) == (
                plans[1].table, plans[1].fresh
            )
            pages = rng.normal(size=(tl.n_pages, tl.page_elems)).astype(np.float32)
            for s, plan in zip(stores, plans):
                s.write_pages(plan, pages)
                s.commit(next_rid, plan)
            live[next_rid] = n
            next_rid += 1
        elif op == "write" and live:
            # the next position, or a rewrite of an earlier one (which
            # splits a prefix-shared page copy-on-write)
            rid = sorted(live)[r % len(live)]
            at = min(r % (live[rid] + 1), W - 1)
            status, _ = both(lambda s: s.prepare_write(rid, at))
            if status == "ok" and at == live[rid]:
                live[rid] += 1
        elif op == "release" and live:
            rid = sorted(live)[r % len(live)]
            for s in stores:
                s.release(rid)
            del live[rid]
        elif op == "evict" and live:
            rid = sorted(live)[r % len(live)]
            _, pairs = both(lambda s: s.evict_request(rid))
            evicted[rid] = ([lp for lp, _ in pairs], live.pop(rid))
        elif op == "resume" and evicted:
            rid = sorted(evicted)[r % len(evicted)]
            logical, n = evicted[rid]
            status, _ = both(lambda s: s.admit_resume(rid, logical))
            if status == "ok":
                live[rid] = n
                del evicted[rid]
        elif op == "materialize" and live:
            rid = sorted(live)[r % len(live)]
            both(lambda s: s.materialize_through(rid, 1 + r % tl.n_pages))
        j, t = stores
        assert j.tables == t.tables
        assert (j.state.free, j.state.refcnt) == (t.state.free, t.state.refcnt)
        assert j._prefix == t._prefix and j._page_key == t._page_key
        assert j.mem.tobytes() == t.mem.tobytes()
        assert j.stats() == t.stats()
        pool.check_pool(t.state, tables=list(t.tables.values()))
