"""The port's model against the JAX reference, same parameters by value.

qwen3-4b at its SMOKE size in f32: the reference initialises the
parameters, ``params_from_jax`` carries them across, and prefill, dense
decode and paged decode must give the reference's logits and caches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import SMOKE as J_SMOKE
from repro.models.build import build_model as j_build
from repro.parallel.ctx import RunCtx as JCtx
from repro.serving import pool as jpool
from repro_torch.compat import tree_leaves, tree_map
from repro_torch.configs.registry import SMOKE
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.parallel.ctx import RunCtx
from repro_torch.serving import pool

# f32 on both sides; differences are summation order through 4 layers
ATOL = 1e-4
CACHE_LEN, PT = 32, 8


@pytest.fixture(scope="module")
def models():
    jm = j_build(J_SMOKE["qwen3-4b"])
    jctx = JCtx(mesh=None, remat="none")
    jparams, _ = jm.init(jctx, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jm, jctx, jparams, build_model(SMOKE["qwen3-4b"]), RunCtx(), tparams


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


def _prompts():
    rng = np.random.default_rng(0)
    return rng.integers(0, 512, size=(2, 11)).astype(np.int32)


def test_params_cross_by_value(models):
    jm, _, jparams, tm, _, tparams = models
    jl, tl = jax.tree.leaves(jparams), tree_leaves(tparams)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    assert tm.dec_segments == [
        type(tm.dec_segments[0])(s.unit, s.count) for s in jm.dec_segments
    ]


def test_prefill_logits_and_caches(models):
    jm, jctx, jparams, tm, ctx, tparams = models
    toks = _prompts()
    jl, jc = jm.prefill(jparams, jctx, {"inputs": jnp.asarray(toks)}, CACHE_LEN)
    tl, tc = tm.prefill(tparams, ctx, {"inputs": torch.from_numpy(toks)}, CACHE_LEN)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=ATOL)
    jleaves, tleaves = jax.tree.leaves(jc), tree_leaves(tc)
    assert [a.shape for a in jleaves] == [tuple(b.shape) for b in tleaves]
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=ATOL, rtol=ATOL)
    # the shape tree the port computes is the one prefill returns
    struct = tm.kv_block_struct(ctx, prompt_len=11, cache_len=CACHE_LEN)
    one = tree_leaves(struct)
    assert [s.shape[:1] + s.shape[2:] for s in one] == [
        tuple(b.shape[:1] + b.shape[2:]) for b in tleaves
    ]
    assert [s.dtype for s in one] == [b.dtype for b in tleaves]


def test_decode_steps_match(models):
    jm, jctx, jparams, tm, ctx, tparams = models
    toks = _prompts()
    jl, jc = jm.prefill(jparams, jctx, {"inputs": jnp.asarray(toks)}, CACHE_LEN)
    tl, tc = tm.prefill(tparams, ctx, {"inputs": torch.from_numpy(toks)}, CACHE_LEN)
    last = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    pos = np.full((2,), 11, np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(
            jparams, jctx, jnp.asarray(last), jnp.asarray(pos), jc
        )
        tl, tc = tm.decode_step(
            tparams, ctx, torch.from_numpy(last), torch.from_numpy(pos), tc
        )
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=ATOL)
        last = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        pos = pos + 1
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=ATOL, rtol=ATOL)


def test_paged_decode_matches_reference_and_dense(models):
    """Paged decode over a scattered pool: the reference's logits and pool
    after each step, and the port's own dense decode logits."""
    jm, jctx, jparams, tm, ctx, tparams = models
    toks = _prompts()[:1]
    jl, jc = jm.prefill(jparams, jctx, {"inputs": jnp.asarray(toks)}, CACHE_LEN)
    tl, tc = tm.prefill(tparams, ctx, {"inputs": torch.from_numpy(toks)}, CACHE_LEN)
    jlayout = jpool.PagedLayout.from_struct(
        jm.kv_block_struct(jctx, prompt_len=11, cache_len=CACHE_LEN),
        cache_len=CACHE_LEN, page_tokens=PT,
    )
    tlayout = pool.PagedLayout.from_struct(
        tm.kv_block_struct(ctx, prompt_len=11, cache_len=CACHE_LEN),
        cache_len=CACHE_LEN, page_tokens=PT,
    )
    pages = np.asarray(jlayout.flatten(jc))
    order = [2, 0, 3, 1]  # scattered physical placement, page 4 spare
    mem = np.zeros((5, jlayout.page_elems), np.float32)
    for lp, ph in enumerate(order):
        mem[ph] = pages[lp]
    jviews = jlayout.decode_views(jnp.asarray(mem))
    tviews = tlayout.decode_views(torch.from_numpy(mem.copy()))
    table = np.asarray([order], np.int32)
    dense = tree_map(lambda x: x.clone(), tc)
    last = np.asarray([[int(np.argmax(np.asarray(jl)[0]))]], np.int32)
    pos = np.asarray([11], np.int32)
    for _ in range(4):
        jl, jviews = jm.decode_step_paged(
            jparams, jctx, jnp.asarray(last), jnp.asarray(pos), jviews,
            jnp.asarray(table),
        )
        tl, tviews = tm.decode_step_paged(
            tparams, ctx, torch.from_numpy(last), torch.from_numpy(pos), tviews,
            torch.from_numpy(table),
        )
        dl, dense = tm.decode_step(
            tparams, ctx, torch.from_numpy(last), torch.from_numpy(pos), dense
        )
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(_np(tl), _np(dl), atol=ATOL, rtol=ATOL)
        last = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        pos = pos + 1
    jmem = np.asarray(jlayout.views_to_pool(jviews))
    tmem = tlayout.views_to_pool(tviews).numpy()
    pos_cols = [
        (leaf.offset, leaf.offset + leaf.size)
        for leaf in tlayout.leaves if leaf.fill == -1
    ]
    np.testing.assert_allclose(tmem, jmem, atol=ATOL, rtol=ATOL)
    for lo, hi in pos_cols:  # the bitcast position columns are exact
        assert tmem[:, lo:hi].tobytes() == jmem[:, lo:hi].tobytes()
