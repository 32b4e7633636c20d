"""The port's recurrent families against the JAX reference, on the CPU.

The plain gated linear scan against the reference's ``lax.scan`` oracle
and its Pallas kernel (interpret mode), the RG-LRU mixer and
sliding-window attention (prefill mask, decode ring).  Then
falcon-mamba-7b and recurrentgemma-9b at their SMOKE sizes in f32, with
the reference's parameters carried across by value: prefill logits and
caches, decode steps past recurrentgemma's window of 16 (the ring
wraps), teacher forcing, the dense ``Server``'s greedy tokens, the cache
shapes, and ``--paged`` refused.  The selective scan itself is held
against the reference in ``tests/test_torch_ssm.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import SMOKE as J_SMOKE
from repro.kernels import ref as jref
from repro.kernels import rglru as jrglru
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models.build import build_model as j_build
from repro.parallel.ctx import RunCtx as JCtx
from repro_torch.compat import tree_leaves
from repro_torch.configs.registry import SMOKE
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.parallel.ctx import RunCtx

ARCH = "recurrentgemma-9b"
# f32 on both sides; the differences are summation order (matmuls, the
# scans' sums, softmax) through 4-5 layers
ATOL = 1e-4
CACHE_LEN = 32  # past the SMOKE window of 16: the local ring wraps
# the reference's gated-linear-scan test shapes (tests/test_kernels.py),
# with its tolerances: f32 at 1e-5, bf16 outputs at 2e-2
SCAN_CASES = [(2, 128, 256, "float32", 1e-5), (1, 64, 512, "float32", 1e-5),
              (2, 128, 256, "bfloat16", 2e-2)]


def _scan_inputs(B, S, W, seed=0):
    """a in [0.1, 0.99] (the RG-LRU's decay range), b of order one."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 0.99, size=(B, S, W)).astype(np.float32)
    b = rng.normal(size=(B, S, W)).astype(np.float32)
    return a, b


def _to(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("B,S,W,dtype,tol", SCAN_CASES)
def test_plain_scan_matches_oracle_and_pallas_kernel(B, S, W, dtype, tol):
    a, b = _scan_inputs(B, S, W)
    ja, jb = (jnp.asarray(v, getattr(jnp, dtype)) for v in (a, b))
    got = ref.gated_linear_scan(_to(a, dtype), _to(b, dtype))
    assert got.dtype == getattr(torch, dtype)
    oracle = np.asarray(jref.gated_linear_scan(ja, jb).astype(jnp.float32))
    pallas = np.asarray(jrglru.gated_linear_scan(
        ja, jb, block_d=128, block_s=32, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), oracle, atol=tol, rtol=tol)
    np.testing.assert_allclose(got.float().numpy(), pallas, atol=tol, rtol=tol)


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunked_scan_matches_reference(chunk):
    """``ref.gated_linear_scan_chunked`` against the reference's chunked
    scan and its oracle (tests/test_kernels.py's shape, S 90: a ragged
    last chunk), and its gradients against ``jax.grad`` of the oracle."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.05, 0.99, size=(2, 90, 48)).astype(np.float32)
    b = rng.normal(size=(2, 90, 48)).astype(np.float32)
    ta, tb = (torch.from_numpy(v).requires_grad_() for v in (a, b))
    got = ops.gated_linear_scan(ta, tb, impl="chunked", block_s=chunk // 2)
    want = jref.gated_linear_scan_chunked(jnp.asarray(a), jnp.asarray(b),
                                          chunk=chunk)
    oracle = jref.gated_linear_scan(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(oracle),
                               atol=3e-5, rtol=3e-5)
    (got ** 2).sum().backward()
    ga, gb = jax.grad(lambda x, y: (jref.gated_linear_scan(x, y) ** 2).sum(),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), atol=5e-4,
                               rtol=5e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), atol=5e-4,
                               rtol=5e-4)


@pytest.mark.parametrize("arch,cut", [
    ("falcon-mamba-7b", {"d_inner": 256, "n_layers": 2}),
    (ARCH, {"n_layers": 2})])
def test_model_level_scan_migration_is_transparent(arch, cut):
    """tests/test_system.py's migration test on the port: the same
    parameters give the same loss with ``scan_impl`` "ref", "pallas" or
    "chunked" (the CPU runs the plain scan for the first two, so they
    are held to the reference's "ref"), each within 1e-3 of the
    reference's loss."""
    import dataclasses

    jcfg = dataclasses.replace(J_SMOKE[arch], **cut)
    jm = j_build(jcfg)
    jparams = jax.jit(lambda k: jm.init(JCtx(mesh=None), k)[0])(
        jax.random.PRNGKey(0))
    tm = build_model(dataclasses.replace(SMOKE[arch], **cut))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 64)).astype(
        np.int32)
    jb = {"inputs": jnp.asarray(toks), "targets": jnp.asarray(toks),
          "mask": jnp.ones((2, 64), jnp.float32)}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    losses = {}
    for impl in ("ref", "pallas", "chunked"):
        jimpl = "chunked" if impl == "chunked" else "ref"
        want = float(jm.train_loss(jparams, JCtx(mesh=None, remat="none",
                                                 scan_impl=jimpl), jb))
        losses[impl] = float(tm.train_loss(tparams, RunCtx(
            remat="none", scan_impl=impl), tb))
        assert abs(losses[impl] - want) < 1e-3, (impl, losses[impl], want)
    assert abs(losses["chunked"] - losses["ref"]) < 1e-3
    with pytest.raises(ValueError, match="scan_impl"):
        RunCtx(scan_impl="assoc")


def test_kernel_wrapper_refuses_cpu_tensors():
    a, b = (torch.from_numpy(v) for v in _scan_inputs(1, 5, 8))
    before = rglru.gated_linear_scan.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru.gated_linear_scan(a, b)
    # meta (the dry run): a shape-only stand-in, no launch
    got = ops.gated_linear_scan(a.to("meta"), b.to("meta"))
    assert got.device.type == "meta" and got.shape == b.shape
    assert got.dtype == b.dtype
    assert rglru.gated_linear_scan.launches == before
    # odd S, B > 1 through ops on the CPU: the plain version
    a, b = (torch.from_numpy(v) for v in _scan_inputs(3, 77, 8, seed=4))
    assert torch.equal(ops.gated_linear_scan(a, b), ref.gated_linear_scan(a, b))


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_rec_mixer_matches_reference(mode):
    """One RG-LRU mixer with the reference's parameters: prefill output and
    cache, then a decode step from that cache (written in place)."""
    cfg_j, cfg_t = J_SMOKE[ARCH], SMOKE[ARCH]
    jp, _ = jlayers.rec_init(cfg_j, JCtx(mesh=None), jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(6).normal(size=(2, 9, 128)).astype(np.float32)
    jctx, ctx = JCtx(mesh=None), RunCtx()
    jo, jc = jlayers.apply_rec(jp, cfg_j, jctx, jnp.asarray(x), mode="prefill")
    to, tc = layers.apply_rec(tp, cfg_t, ctx, torch.from_numpy(x),
                              mode="prefill")
    if mode == "decode":
        x1 = x[:, :1] * 0.5
        jo, jc = jlayers.apply_rec(jp, cfg_j, jctx, jnp.asarray(x1),
                                   mode="decode", cache=jc)
        tc = {k: v.clone() for k, v in tc.items()}
        held = dict(tc)
        to, tc = layers.apply_rec(tp, cfg_t, ctx, torch.from_numpy(x1),
                                  mode="decode", cache=tc)
        assert all(tc[k] is held[k] for k in held)  # updated in place
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=1e-5)
    for k in ("conv", "h"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("S,window", [(40, 16), (40, 7), (9, 16)])
def test_windowed_chunked_attention_matches_reference(S, window):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, S, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, S, 1, 8)).astype(np.float32)
    v = rng.normal(size=(2, S, 1, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    want = jlayers._chunked_attention(
        *map(jnp.asarray, (q, k, v, pos, pos)), causal=True, window=window,
        scale=0.35, chunk=16)
    got = layers._chunked_attention(
        *map(torch.from_numpy, (q, k, v, pos.copy(), pos.copy())), scale=0.35,
        chunk=16, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# --------------------------------------------------------------------------- #
# the model at SMOKE size, the reference's parameters
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=["falcon-mamba-7b", ARCH])
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


def _prefill_both(models, toks):
    jm, jctx, jparams, tm, ctx, tparams = models
    jl, jc = jm.prefill(jparams, jctx, {"inputs": jnp.asarray(toks)}, CACHE_LEN)
    tl, tc = tm.prefill(tparams, ctx, {"inputs": torch.from_numpy(toks)},
                        CACHE_LEN)
    return (jl, jc), (tl, tc)


def test_params_cross_with_the_reference_keys_and_dtypes(models):
    jm, jctx, jparams, tm, ctx, tparams = models
    own = tm.init(ctx, torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jflat) == len(tree_leaves(own)) == len(tree_leaves(tparams))
    for (path, a), b in zip(jflat, tree_leaves(own)):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).split(".")[-1], path


def test_prefill_logits_and_caches(models):
    (jl, jc), (tl, tc) = _prefill_both(models, _prompts())
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=ATOL)
    jleaves, tleaves = jax.tree.leaves(jc), tree_leaves(tc)
    assert [a.shape for a in jleaves] == [tuple(b.shape) for b in tleaves]
    for a, b in zip(jleaves, tleaves):
        assert str(a.dtype) == str(b.dtype).split(".")[-1]
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=ATOL, rtol=ATOL)


def test_decode_steps_match(models):
    jm, jctx, jparams, tm, ctx, tparams = models
    (jl, jc), (tl, tc) = _prefill_both(models, _prompts())
    last = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    pos = np.full((2,), 20, np.int32)
    for _ in range(6):
        jl, jc = jm.decode_step(jparams, jctx, jnp.asarray(last),
                                jnp.asarray(pos), jc)
        tl, tc = tm.decode_step(tparams, ctx, torch.from_numpy(last),
                                torch.from_numpy(pos), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=ATOL)
        last = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        pos = pos + 1
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=ATOL, rtol=ATOL)


def test_train_logits_match(models):
    jm, jctx, jparams, tm, ctx, tparams = models
    toks = _prompts(2, 24)
    jb = {"inputs": jnp.asarray(toks), "targets": jnp.asarray(toks),
          "mask": jnp.ones(toks.shape)}
    tb = {"inputs": torch.from_numpy(toks)}
    np.testing.assert_allclose(
        _np(tm.train_logits(tparams, ctx, tb)),
        np.asarray(jm.train_logits(jparams, jctx, jb)), atol=ATOL, rtol=ATOL)


def test_decode_matches_teacher_forcing(models):
    """tests/test_arch_smoke.py's state-carry check, on the port, past
    recurrentgemma's window: prefill of 18 tokens into a 32-token cache (a
    ring of 16 slots, wrapped) then 8 decode steps give the full forward's
    logits."""
    _, _, _, tm, ctx, tparams = models
    toks = torch.from_numpy(_prompts(1, 26))
    full = _np(tm.train_logits(tparams, ctx, {"inputs": toks}))
    logits, caches = tm.prefill(tparams, ctx, {"inputs": toks[:, :18]},
                                CACHE_LEN)
    np.testing.assert_allclose(full[0, 17], _np(logits)[0], atol=2e-4,
                               rtol=2e-4)
    for t in range(18, 26):
        logits, caches = tm.decode_step(
            tparams, ctx, toks[:, t:t + 1], torch.tensor([t], dtype=torch.int32),
            caches)
        np.testing.assert_allclose(full[0, t], _np(logits)[0], atol=5e-4,
                                   rtol=5e-4)


def _requests(mod):
    rng = np.random.default_rng(5)
    return [mod.Request(rid=i, prompt=rng.integers(0, 512, size=int(n)).tolist(),
                        max_new=int(m))
            for i, (n, m) in enumerate([(19, 6), (4, 8), (22, 8), (7, 7), (17, 4)])]


def _serve(server, reqs):
    for r in reqs:
        server.submit(r)
    server.run_until_drained()
    return {r.rid: r.out for r in server.finished}


def test_server_tokens_match_reference(models):
    jm, jctx, jparams, tm, ctx, tparams = models
    want = _serve(jserve.Server(jm, jctx, jparams, 3, CACHE_LEN),
                  _requests(jserve))
    got = _serve(serve.Server(tm, ctx, tparams, 3, CACHE_LEN, device="cpu"),
                 _requests(serve))
    assert got == want and len(got) == 5


def test_kv_block_struct_matches_reference(models):
    jm, jctx, _, tm, ctx, _ = models
    for batch in (1, 3):
        want = jax.tree.leaves(jm.kv_block_struct(jctx, 5, CACHE_LEN, batch))
        got = tree_leaves(tm.kv_block_struct(ctx, 5, CACHE_LEN, batch))
        assert [tuple(s.shape) for s in want] == [s.shape for s in got]
        assert [str(s.dtype) for s in want] == [
            str(s.dtype).split(".")[-1] for s in got]


def test_paged_serving_refused_as_in_reference(models):
    jm, jctx, jparams, tm, ctx, tparams = models
    with pytest.raises(ValueError):
        jserve.PagedServer(jm, jctx, jparams, 2, CACHE_LEN, page_tokens=8)
    with pytest.raises(ValueError, match="paged decode unsupported"):
        serve.PagedServer(tm, ctx, tparams, 2, CACHE_LEN, device="cpu",
                          page_tokens=8)
    with pytest.raises(ValueError, match="paged decode unsupported"):
        serve.main(["--arch", tm.cfg.name, "--paged", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", ARCH])
def test_serve_main_runs_on_cpu(capsys, arch):
    serve.main(["--role", "decode", "--arch", arch, "--device", "cpu",
                "--requests", "3", "--batch", "2", "--max-new", "3"])
    assert "requests: 3" in capsys.readouterr().out
