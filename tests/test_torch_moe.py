"""The port's MoE path against the JAX reference, on the CPU.

The plain router against the reference's oracle ``route_topk`` and its
Pallas kernel ``moe_router`` (interpret mode) at the reference tests'
four cases and at kimi-k2's width (E 384, K 8), with and without ties;
dispatch and combine bit for bit, a NaN behind a dropped choice
included; the MoE FFN; then kimi-k2-1t-a32b (a ``dense`` layer, then
``moe`` layers with a shared expert) and arctic-480b (``moe`` layers with
a dense residual FFN) at their SMOKE sizes in f32, with the reference's
parameters carried across by value: prefill logits and caches, decode
steps, and the ``Server`` and ``PagedServer`` tokens against the
reference's own servers with rows that die mid-run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import SMOKE as J_SMOKE
from repro.kernels import moe_dispatch as jmoe
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models.build import build_model as j_build
from repro.parallel.ctx import RunCtx as JCtx
from repro_torch.compat import tree_leaves
from repro_torch.configs.registry import ARCHS, SMOKE
from repro_torch.kernels import moe_router, ops, ref
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.parallel.ctx import RunCtx

ARCHS_MOE = ["kimi-k2-1t-a32b", "arctic-480b"]
# f32 on both sides; the differences are summation order (matmuls,
# softmax, norms) through 2-3 layers
ATOL = 1e-4
CACHE_LEN = 48  # not head_dim (32): the pool finds the token axis by size
# (T, E, K, capacity, Pallas block_t): the reference's four router cases
# (tests/test_kernels.py) and one at kimi-k2's width, several blocks
ROUTER_CASES = [(512, 16, 2, 80, 128), (256, 8, 1, 64, 256),
                (512, 64, 8, 72, 64), (256, 128, 2, 8, 128),
                (256, 384, 8, 8, 128)]


def _logits(T, E, ties, seed=0):
    """Normal logits; with ``ties``, rounded to halves (many equal
    probabilities in a row) and every fourth row constant."""
    x = np.random.default_rng(seed).normal(size=(T, E)).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2
        x[::4] = 0.5
    return x


def _check_routes(got, want):
    e, s, w, k = (np.asarray(v) for v in got)
    we, ws, ww, wk = (np.asarray(v) for v in want)
    np.testing.assert_array_equal(e, we)
    np.testing.assert_array_equal(s, ws)
    np.testing.assert_array_equal(k, wk)
    np.testing.assert_allclose(w, ww, atol=1e-6, rtol=0)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("T,E,K,C,bt", ROUTER_CASES)
def test_plain_router_matches_oracle_and_pallas_kernel(T, E, K, C, bt, ties):
    x = _logits(T, E, ties)
    got = ref.route_topk(torch.from_numpy(x), k=K, capacity=C)
    assert [t.dtype for t in got] == [torch.int32, torch.int32,
                                      torch.float32, torch.bool]
    assert all(tuple(t.shape) == (T, K) for t in got)
    _check_routes(got, jref.route_topk(jnp.asarray(x), k=K, capacity=C))
    _check_routes(got, jmoe.moe_router(jnp.asarray(x), k=K, capacity=C,
                                       block_t=bt, interpret=True))


@pytest.mark.parametrize("T", [1, 77])
def test_plain_router_without_renormalisation_and_ragged_T(T):
    """No renormalisation (raw softmax weights) and a T no block divides,
    at kimi-k2's width; the Pallas kernel needs T % block_t == 0, so the
    oracle alone is the reference here."""
    x = _logits(T, 384, ties=T > 1, seed=2)
    for renormalize in (True, False):
        got = ref.route_topk(torch.from_numpy(x), k=8, capacity=4,
                             renormalize=renormalize)
        _check_routes(got, jref.route_topk(jnp.asarray(x), k=8, capacity=4,
                                           renormalize=renormalize))


def test_router_wrapper_refuses_cpu_tensors():
    x = torch.from_numpy(_logits(9, 16, ties=False))
    before = moe_router.moe_router.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        moe_router.moe_router(x, k=2, capacity=4)
    # meta (the dry run): the plain version's shapes, no launch
    got = ops.moe_router(x.to("meta"), k=2, capacity=4)
    assert [(t.device.type, t.shape, t.dtype) for t in got] == [
        ("meta", t.shape, t.dtype) for t in ref.route_topk(x, k=2, capacity=4)]
    assert moe_router.moe_router.launches == before
    for a, b in zip(ops.moe_router(x, k=2, capacity=4),
                    ref.route_topk(x, k=2, capacity=4)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("T", [1, 8, 16, 17, 128, 192, 193, 1056, 8192, 10**6])
def test_router_plan_covers_every_token_once_in_one_wave(T, sms):
    """The launch plan: CTA b routes tokens [b W tpw, (b + 1) W tpw), so
    the CTAs cover T and every token once when ctas W tpw >= T and the
    last CTA holds a token; one CTA and a cluster (at most 16 CTAs) take
    a token a warp, a grid at most one 32-warp CTA a SM (one wave); the
    kernel's packed in-warp ranks need tpw < 2**22."""
    mr = moe_router
    for max_cluster in (16, 8, 1):
        p = mr.plan(T, sms, max_cluster)
        assert 1 <= p.warps <= mr.MAX_WARPS and 1 <= p.tpw < 2**22
        per_cta = p.warps * p.tpw
        assert p.ctas * per_cta >= T > (p.ctas - 1) * per_cta
        if p.mode == mr.CTA:
            assert p.ctas == 1 and p.tpw == 1 and T <= mr.regime_edges()[0]
        elif p.mode == mr.CLUSTER:  # the kernel's masks: a token a warp
            assert 2 <= p.ctas <= max_cluster <= mr.MAX_CLUSTER
            assert p.tpw == 1 and T <= mr.regime_edges(max_cluster)[1]
        else:
            assert p.mode == mr.GRID and p.ctas <= sms
            assert p.warps in (mr.GRID_WARPS, mr.MAX_WARPS)
            assert T > mr.regime_edges(max_cluster)[1] or max_cluster == 1


def test_router_plan_regimes_by_T():
    """Decode batches take one CTA, the 128-token prefill one cluster of
    16 CTAs (a grid where the card holds no cluster of 16), long prefills
    a grid of one wave: 16-warp CTAs while a token a warp fits, then 32
    warps a CTA and several tokens a warp."""
    mr = moe_router
    assert mr.plan(8, 132) == mr.Plan(mr.CTA, 1, 8, 1)
    assert mr.plan(128, 132) == mr.Plan(mr.CLUSTER, 16, 8, 1)
    assert mr.plan(128, 132, 8) == mr.Plan(mr.GRID, 8, 16, 1)
    assert mr.plan(2048, 132) == mr.Plan(mr.GRID, 128, 16, 1)
    assert mr.plan(8192, 132) == mr.Plan(mr.GRID, 128, 32, 2)
    assert mr.plan(8192, 114) == mr.Plan(mr.GRID, 86, 32, 3)


def test_dispatch_and_combine_bit_exact():
    """f32, capacities small enough that choices drop, the same routes on
    both sides (the two softmaxes may differ in the last bit of a weight);
    a NaN in the expert-output row a dropped choice's clamped slot reads
    (C - 1) makes that token NaN in both packages (0 x NaN), and nowhere
    else."""
    rng = np.random.default_rng(3)
    T, D, E, K, C = 40, 16, 8, 2, 4
    x = _logits(T, E, ties=False, seed=3)
    tok = rng.normal(size=(T, D)).astype(np.float32)
    je, js, jw, jk = jref.route_topk(jnp.asarray(x), k=K, capacity=C)
    e, s, w, keep = (torch.from_numpy(np.array(v)) for v in (je, js, jw, jk))
    assert not bool(keep.all())
    got = ops.moe_dispatch(torch.from_numpy(tok), e, s, keep, n_experts=E,
                           capacity=C)
    want = jref.moe_dispatch(jnp.asarray(tok), je, js, jk, n_experts=E,
                             capacity=C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    out = rng.normal(size=(E, C, D)).astype(np.float32)
    t_drop, j_drop = np.argwhere(~keep.numpy())[0]
    out[int(e[t_drop, j_drop]), C - 1] = np.nan
    got = ops.moe_combine(torch.from_numpy(out), e, s, w, keep)
    want = np.asarray(jref.moe_combine(jnp.asarray(out), je, js, jw, jk))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(want[t_drop]).all()
    assert not np.isnan(want).all()


@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_apply_moe_matches_reference(arch):
    """One MoE FFN with the reference's parameters (kimi's shared expert,
    arctic's dense residual), 18 tokens: capacity 6, choices dropped."""
    cfg_j, cfg_t = J_SMOKE[arch], SMOKE[arch]
    jp, _ = jlayers.moe_init(cfg_j, JCtx(mesh=None), jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    assert tp["router"].dtype == torch.float32
    assert ("shared" in tp) == (arch == "kimi-k2-1t-a32b")
    assert ("dense_res" in tp) == (arch == "arctic-480b")
    x = np.random.default_rng(6).normal(size=(2, 9, 128)).astype(np.float32)
    assert layers.moe_capacity(cfg_t, 18) == 6
    want = jlayers.apply_moe(jp, cfg_j, JCtx(mesh=None), jnp.asarray(x))
    got = layers.apply_moe(tp, cfg_t, RunCtx(), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_configs_and_layer_kinds_match_reference():
    from repro.configs.registry import ARCHS as J_ARCHS

    for arch in ARCHS_MOE:
        for jc, tc in ((J_ARCHS[arch], ARCHS[arch]),
                       (J_SMOKE[arch], SMOKE[arch])):
            assert tc.layer_kinds() == jc.layer_kinds()
            assert tc.resolved_d_ff_dense == jc.resolved_d_ff_dense
            for f in ("n_experts", "top_k", "capacity_factor", "d_model",
                      "moe_dense_residual", "n_shared_experts", "vocab",
                      "first_dense_layers", "d_ff", "n_heads", "n_kv_heads"):
                assert getattr(tc, f) == getattr(jc, f), (arch, f)
    assert ARCHS["kimi-k2-1t-a32b"].layer_kinds()[:2] == ["dense", "moe"]


# --------------------------------------------------------------------------- #
# the models at SMOKE size, the reference's parameters
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=ARCHS_MOE)
def models(request):
    arch = request.param
    jm = j_build(J_SMOKE[arch])
    jctx = JCtx(mesh=None, remat="none")
    jparams, _ = jm.init(jctx, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return jm, jctx, jparams, build_model(SMOKE[arch]), RunCtx(), tparams


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


def _prompts(B=2, S=20):
    return np.random.default_rng(0).integers(0, 512, size=(B, S)).astype(np.int32)


def test_params_cross_with_the_reference_keys_and_dtypes(models):
    jm, jctx, jparams, tm, ctx, tparams = models
    own = tm.init(ctx, torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jflat) == len(tree_leaves(own)) == len(tree_leaves(tparams))
    for (path, a), b in zip(jflat, tree_leaves(own)):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).split(".")[-1], path


def test_prefill_logits_caches_and_decode_steps(models):
    jm, jctx, jparams, tm, ctx, tparams = models
    toks = _prompts()
    jl, jc = jm.prefill(jparams, jctx, {"inputs": jnp.asarray(toks)}, CACHE_LEN)
    tl, tc = tm.prefill(tparams, ctx, {"inputs": torch.from_numpy(toks)},
                        CACHE_LEN)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=ATOL)
    jleaves, tleaves = jax.tree.leaves(jc), tree_leaves(tc)
    assert [a.shape for a in jleaves] == [tuple(b.shape) for b in tleaves]
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=ATOL, rtol=ATOL)
    last = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    pos = np.full((2,), 20, np.int32)
    for _ in range(5):
        jl, jc = jm.decode_step(jparams, jctx, jnp.asarray(last),
                                jnp.asarray(pos), jc)
        tl, tc = tm.decode_step(tparams, ctx, torch.from_numpy(last),
                                torch.from_numpy(pos), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=ATOL)
        last = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        pos = pos + 1


def test_kv_block_struct_matches_reference(models):
    jm, jctx, _, tm, ctx, _ = models
    for batch in (1, 3):
        want = jax.tree.leaves(jm.kv_block_struct(jctx, 5, CACHE_LEN, batch))
        got = tree_leaves(tm.kv_block_struct(ctx, 5, CACHE_LEN, batch))
        assert [tuple(s.shape) for s in want] == [s.shape for s in got]
        assert [str(s.dtype) for s in want] == [
            str(s.dtype).split(".")[-1] for s in got]


def _requests(mod):
    """Mixed prompt lengths, a staggered max_new (rows die mid-run and
    their stale rows keep routing), two sharing a 16-token prefix."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 512, size=16).tolist()
    reqs = [mod.Request(rid=0, prompt=shared + [5], max_new=6),
            mod.Request(rid=1, prompt=shared + [9, 11], max_new=3)]
    for rid, (n, m) in enumerate([(4, 8), (22, 2), (7, 7), (13, 5)], start=2):
        reqs.append(mod.Request(
            rid=rid, prompt=rng.integers(0, 512, size=n).tolist(), max_new=m))
    return reqs


def _serve(server, reqs):
    for r in reqs:
        server.submit(r)
    stats = server.run_until_drained()
    return {r.rid: r.out for r in server.finished}, stats


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_server_tokens_match_reference(models, paged):
    """Each of the port's servers against the reference's same server:
    MoE capacity is per call, so dead rows (stale tokens, the scratch page
    in the paged server) shape the batch's routing, and the two servers
    are held to their own counterparts, not to each other."""
    jm, jctx, jparams, tm, ctx, tparams = models
    if paged:
        want, _ = _serve(jserve.PagedServer(jm, jctx, jparams, 3, CACHE_LEN,
                                            page_tokens=8), _requests(jserve))
        server = serve.PagedServer(tm, ctx, tparams, 3, CACHE_LEN,
                                   device="cpu", page_tokens=8)
    else:
        want, _ = _serve(jserve.Server(jm, jctx, jparams, 3, CACHE_LEN),
                         _requests(jserve))
        server = serve.Server(tm, ctx, tparams, 3, CACHE_LEN, device="cpu")
    got, stats = _serve(server, _requests(serve))
    assert got == want and len(got) == 6
    assert {rid: len(o) for rid, o in got.items()} == {
        0: 6, 1: 3, 2: 8, 3: 2, 4: 7, 5: 5}
    if paged:
        assert stats["pool_prefix_hits"] >= 2
        assert stats["pool_n_free"] == stats["pool_n_pages"]


@pytest.mark.parametrize("arch", ARCHS_MOE)
def test_serve_main_runs_paged_on_cpu(capsys, arch):
    serve.main(["--role", "decode", "--paged", "--arch", arch, "--device",
                "cpu", "--requests", "3", "--batch", "2", "--max-new", "3"])
    assert "requests: 3" in capsys.readouterr().out
