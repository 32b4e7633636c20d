"""``PagedServer``'s row path and its tier and scheduler options, against
the JAX reference's, same parameters.

qwen3-4b SMOKE in f32 on the CPU.  ``paged_decode=False`` admits a full
table of pages, decodes on dense rows read back through the page table
and writes the written page back every step: the pool must stay
canonical and the tokens must be the reference's row path's and the
paged path's.  ``tier_slots`` sizes the host tier and ``sched_costs``
prices the scheduler's swaps: under pressure the port and the reference
must make the same choices and give the same tokens.
"""

import jax
import numpy as np
import pytest

from repro.configs.registry import SMOKE as J_SMOKE
from repro.core import sched as jsched
from repro.launch import serve as jserve
from repro.models.build import build_model as j_build
from repro.parallel.ctx import RunCtx as JCtx
from repro_torch.compat import tree_leaves, tree_map
from repro_torch.configs.registry import SMOKE
from repro_torch.core import sched
from repro_torch.launch import serve
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.parallel.ctx import RunCtx


@pytest.fixture(scope="module")
def models():
    cfg = J_SMOKE["qwen3-4b"]
    jm = j_build(cfg)
    jctx = JCtx(mesh=None, remat="none")
    jparams, _ = jm.init(jctx, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return (jm, jctx, jparams), (build_model(SMOKE["qwen3-4b"]), RunCtx(),
                                 tparams)


def _burst(mod, n=5):
    """Requests of mixed lengths, two sharing a 16-token prompt prefix."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 512, size=16).tolist()
    reqs = [
        mod.Request(rid=0, prompt=shared + [5], max_new=6),
        mod.Request(rid=1, prompt=shared + [9, 11], max_new=5),
    ]
    for rid in range(2, n):
        reqs.append(mod.Request(
            rid=rid,
            prompt=rng.integers(0, 512, size=int(rng.integers(6, 18))).tolist(),
            max_new=int(rng.integers(6, 12)),
        ))
    return reqs


def _serve(server, reqs, **kw):
    for r in reqs:
        server.submit(r)
    stats = server.run_until_drained(**kw)
    return {r.rid: r.out for r in server.finished}, stats


def test_dense_row_pool_stays_canonical(models):
    """Every decode step writes its dirty page back, so a gather through
    the page table returns the row's current bytes (the reference's
    ``test_dense_paged_server_pool_stays_canonical``)."""
    _, (tm, ctx, tparams) = models
    rng = np.random.default_rng(6)
    srv = serve.PagedServer(tm, ctx, tparams, 2, 32, device="cpu",
                            page_tokens=8, paged_decode=False)
    srv.submit(serve.Request(
        rid=0, prompt=rng.integers(0, SMOKE["qwen3-4b"].vocab, 9).tolist(),
        max_new=6))
    for _ in range(4):
        srv.step()
    assert srv.profile_decode(None) is None  # no paged step to time
    row = tree_map(lambda x: x[:, 0:1], srv.caches)
    gathered = srv.store.gather(0)
    for a, b in zip(tree_leaves(row), tree_leaves(gathered)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_dense_row_tokens_match_reference_and_paged(models):
    (jm, jctx, jparams), (tm, ctx, tparams) = models
    want, _ = _serve(
        jserve.PagedServer(jm, jctx, jparams, 3, 32, page_tokens=8,
                           paged_decode=False),
        _burst(jserve),
    )
    got, stats = _serve(
        serve.PagedServer(tm, ctx, tparams, 3, 32, device="cpu",
                          page_tokens=8, paged_decode=False),
        _burst(serve),
    )
    paged, _ = _serve(
        serve.PagedServer(tm, ctx, tparams, 3, 32, device="cpu",
                          page_tokens=8),
        _burst(serve),
    )
    assert got == want
    assert got == paged
    assert stats["pool_prefix_hits"] >= 2  # rid 0/1 share two full pages
    assert stats["pool_n_free"] == stats["pool_n_pages"]


def test_tier_slots_reach_the_tier_as_in_the_reference(models):
    (jm, jctx, jparams), (tm, ctx, tparams) = models
    for kw in ({}, {"tier_slots": 5}, {"n_pool_pages": 40}):
        want = jserve.PagedServer(jm, jctx, jparams, 3, 32, page_tokens=8,
                                  **kw).tier.stats()
        got = serve.PagedServer(tm, ctx, tparams, 3, 32, device="cpu",
                                page_tokens=8, **kw).tier.stats()
        assert got["tier_slots"] == want["tier_slots"]
        assert got["tier_free_slots"] == want["tier_free_slots"]
    assert got["tier_slots"] == 40  # the pool's size when it is larger


def test_tensor_parallel_server_decodes_through_pages_only(models):
    _, (tm, ctx, tparams) = models
    with pytest.raises(ValueError, match="page table only"):
        serve.TPPagedServer(tm, ctx, tparams, 2, 32, device="cpu", tp=2,
                            paged_decode=False)


# unpressured by these options the burst's one victim swaps its 2 pages
# out; a wire so slow that recompute is cheaper, or a tier of 1 slot that
# cannot hold them (the swap falls back to recompute), turn it around
PRESSURE = [
    ("sched_costs", lambda mod: {"sched_costs": {
        "xla": mod.EngineCost(alpha_us=1e6, beta_us_per_kib=1e4,
                              gamma_us_per_kib=0.0)}}),
    ("tier_slots", lambda mod: {"tier_slots": 1}),
]


@pytest.mark.parametrize("name,options", PRESSURE, ids=[p[0] for p in PRESSURE])
def test_pressured_choices_and_tokens_match_reference(models, name, options):
    """A 7-page pool under six requests: the scheduler preempts, and the
    port makes the reference's swap/recompute choices, gives its tokens
    and those of an unpressured run, and drains pool and tier."""
    (jm, jctx, jparams), (tm, ctx, tparams) = models
    base, _ = _serve(
        serve.PagedServer(tm, ctx, tparams, 3, 32, device="cpu",
                          page_tokens=8),
        _burst(serve, 6),
    )
    want, wstats = _serve(
        jserve.PagedServer(jm, jctx, jparams, 3, 32, page_tokens=8,
                           n_pool_pages=7, **options(jsched)),
        _burst(jserve, 6), max_ticks=500,
    )
    got, stats = _serve(
        serve.PagedServer(tm, ctx, tparams, 3, 32, device="cpu",
                          page_tokens=8, n_pool_pages=7, **options(sched)),
        _burst(serve, 6), max_ticks=500,
    )
    assert got == want == base
    for key in ("sched_evictions", "sched_swaps", "sched_recomputes",
                "sched_resumes", "tier_swapped_out_pages"):
        assert stats[key] == wstats[key], key
    assert stats["sched_evictions"] >= 1 and stats["sched_swaps"] == 0
    assert stats["sched_recomputes"] >= 1
    assert stats["pool_n_free"] == stats["pool_n_pages"]
    assert stats["tier_free_slots"] == stats["tier_slots"]
