"""The rest of the model zoo against the JAX reference, on the CPU.

gemma3-27b (5 local : 1 global, qk-norm, tied embeddings), granite-34b
(MQA, GELU, an ungated FFN), llama3-405b, llama-3.2-vision-11b (gated
``cross`` blocks onto image embeddings) and seamless-m4t-medium
(layernorm, GELU, an ungated FFN, a bidirectional ``enc`` stack and
``xdec`` blocks): configs and parameter counts equal to the reference's,
the new layers (layernorm, GELU, the ungated MLP, bidirectional and
cross-attention) on the same inputs, then each arch at its SMOKE size in
f32 with the reference's parameters carried across by value: training
logits, loss and gradients, prefill logits and caches, decode steps (the
reference's decode of a cross sub-block, R1 in ROADMAP.md §3, included),
and the servers' tokens against the reference's own servers.
llama-3.2-vision's ``xgate`` is set to 0.5 (the init's 0 would close the
image path, hiding it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models.build import build_model as j_build
from repro.parallel.ctx import RunCtx as JCtx
from repro_torch.compat import tree_leaves
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.parallel.ctx import RunCtx

NEW = ["gemma3-27b", "granite-34b", "llama3-405b", "llama-3.2-vision-11b",
       "seamless-m4t-medium"]
# f32 on both sides; the differences are summation order (matmuls,
# softmax, norms) through 2-8 layers (tests/test_torch_model.py)
ATOL = 1e-4
# gradients sum B S products more than the forward's; the same f32 order
GRAD_ATOL = 2e-4
# bf16 layers: both round their output to bf16 (8 bits of mantissa on
# values of order 1), from f32 internals computed in different orders
BF16_ATOL = 3e-2
CACHE_LEN = 48  # past gemma3's SMOKE window of 16; not a head_dim
XGATE = 0.5
S_ENC = 12  # seamless frames a row (the encoder's length)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


def _dtype_name(d):
    return str(d).split(".")[-1]


# --------------------------------------------------------------------------- #
# configs and the registry
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("which", ["ARCHS", "SMOKE"])
@pytest.mark.parametrize("arch", NEW)
def test_config_equals_reference_field_by_field(arch, which):
    want = getattr(jreg, which)[arch]
    got = getattr(registry, which)[arch]
    names = [f.name for f in dataclasses.fields(want)]
    assert names == [f.name for f in dataclasses.fields(got)]
    for name in names:
        a, b = getattr(want, name), getattr(got, name)
        if name == "dtype":
            assert jnp.dtype(a).name == _dtype_name(b), arch
        else:
            assert a == b, (arch, name)
    assert got.layer_kinds() == want.layer_kinds()
    assert got.attention_free == want.attention_free
    assert got.resolved_head_dim == want.resolved_head_dim


@pytest.mark.parametrize("which", ["ARCHS", "SMOKE"])
@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_param_counts_equal_reference_for_all_archs(arch, which):
    assert (getattr(registry, which)[arch].param_counts()
            == getattr(jreg, which)[arch].param_counts())


def test_registry_cells_and_full_config_ranges():
    """The reference's ``test_param_counts_full_configs`` ranges and its
    ``long_500k`` rule on the port's registry, and the same cells."""
    assert list(registry.ARCHS) == list(jreg.ARCHS)
    assert {k: dataclasses.astuple(v) for k, v in registry.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jreg.SHAPES.items()}
    assert registry.all_cells() == jreg.all_cells()
    assert registry.runnable_cells() == jreg.runnable_cells()
    assert len(registry.runnable_cells()) == 33
    totals = {n: c.param_counts()[0] for n, c in registry.ARCHS.items()}
    assert 3.8e11 < totals["llama3-405b"] < 4.3e11
    assert 3.0e10 < totals["granite-34b"] < 3.8e10
    assert 3.5e9 < totals["qwen3-4b"] < 4.8e9
    assert 2.3e10 < totals["gemma3-27b"] < 3.0e10
    assert 4.0e11 < totals["arctic-480b"] < 5.5e11
    assert 0.9e12 < totals["kimi-k2-1t-a32b"] < 1.2e12
    assert 6.0e9 < totals["falcon-mamba-7b"] < 8.5e9
    assert 7.5e9 < totals["recurrentgemma-9b"] < 1.1e10
    act = {n: c.param_counts()[1] for n, c in registry.ARCHS.items()}
    assert 2.4e10 < act["kimi-k2-1t-a32b"] < 4.0e10
    assert act["arctic-480b"] < 4.5e10
    runnable = [a for a in registry.ARCHS
                if registry.cell_runnable(a, "long_500k")[0]]
    assert sorted(runnable) == [
        "falcon-mamba-7b", "gemma3-27b", "recurrentgemma-9b"]
    for a in registry.ARCHS:
        for s in ("train_4k", "prefill_32k", "decode_32k"):
            assert registry.cell_runnable(a, s) == jreg.cell_runnable(a, s)


# --------------------------------------------------------------------------- #
# the new layers on the same inputs
# --------------------------------------------------------------------------- #
def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _both(x, dtype):
    """``x`` as a JAX array and a torch tensor of one dtype (bf16 rounded
    once, by JAX, and carried by its bits)."""
    j = jnp.asarray(x).astype(dtype)
    return j, params_from_jax(np.asarray(j))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind, dtype):
    jx, tx = _both(_rand((3, 5, 128), 0, 3.0) + 1.5, dtype)
    scale = _rand((128,), 1) * 0.1 + 1.0
    want = jlayers.apply_norm({"scale": jnp.asarray(scale)}, jx, kind)
    got = layers.apply_norm({"scale": torch.from_numpy(scale)}, tx, kind)
    assert got.dtype == tx.dtype
    tol = ATOL if dtype == jnp.float32 else BF16_ATOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("arch", ["granite-34b", "seamless-m4t-medium",
                                  "llama3-405b"])
def test_mlp_matches_reference(arch, dtype):
    """GELU and the ungated FFN (granite, seamless with layernorm), the
    gated SiLU FFN beside them; no ``wg`` leaf when ungated."""
    jcfg = dataclasses.replace(jreg.SMOKE[arch], dtype=dtype)
    tcfg = dataclasses.replace(
        registry.SMOKE[arch],
        dtype=torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    jp, _ = jlayers.mlp_init(jcfg, JCtx(mesh=None), jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    own = layers.mlp_init(tcfg, RunCtx(), torch.Generator().manual_seed(0))
    assert sorted(own) == sorted(jp)
    assert ("wg" in own) == tcfg.mlp_gated
    jx, tx = _both(_rand((2, 7, tcfg.d_model), 3), dtype)
    want = jlayers.apply_mlp(jp, jcfg, jx)
    got = layers.apply_mlp(tp, tcfg, tx, RunCtx())
    tol = ATOL if dtype == jnp.float32 else BF16_ATOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_masks_match_reference(causal, window):
    """Causal, bidirectional and the two-sided window, over a cache with
    empty slots (-1) and padded query chunks."""
    B, Sq, Sk, H, KH, Dh = 2, 9, 11, 4, 2, 16
    q, k, v = (_rand((B, s, h, Dh), i) for i, (s, h) in
               enumerate([(Sq, H), (Sk, KH), (Sk, KH)]))
    qpos = np.tile(np.arange(2, 2 + Sq, dtype=np.int32), (B, 1))
    kpos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    kpos[1, 7:] = -1
    want = jlayers._chunked_attention(
        *map(jnp.asarray, (q, k, v, qpos, kpos)), causal=causal,
        window=window, scale=0.25, chunk=4)
    got = layers._chunked_attention(
        *map(torch.from_numpy, (q, k, v, qpos, kpos)), causal=causal,
        window=window, scale=0.25, chunk=4)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("what", ["enc", "cross"])
def test_attention_bidirectional_and_cross_match_reference(what, mode):
    """``apply_attention`` with ``causal=False`` (the ``enc`` kind; the
    flash kernels' plain versions in train) and with ``xkv`` (no rope,
    k-normed on gemma3's qk-norm, a prefill cache at the encoder's
    length)."""
    arch = "gemma3-27b" if what == "cross" else "seamless-m4t-medium"
    jcfg, tcfg = jreg.SMOKE[arch], registry.SMOKE[arch]
    jp, _ = jlayers.attention_init(jcfg, JCtx(mesh=None), jax.random.PRNGKey(4))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    B, S = 2, 10
    x = _rand((B, S, tcfg.d_model), 5)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    kw = {"causal": False} if what == "enc" else {}
    jkw, tkw = dict(kw), dict(kw)
    if what == "cross":
        xkv = _rand((B, 7, tcfg.d_model), 6)
        jkw["xkv"], tkw["xkv"] = jnp.asarray(xkv), torch.from_numpy(xkv)
    want, jc = jlayers.apply_attention(
        jp, jcfg, JCtx(mesh=None), jnp.asarray(x), positions=jnp.asarray(pos),
        mode=mode, cache_len=16, **jkw)
    got, tc = layers.apply_attention(
        tp, tcfg, RunCtx(), torch.from_numpy(x), positions=torch.from_numpy(pos),
        mode=mode, cache_len=16, **tkw)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=ATOL)
    if mode == "prefill":
        assert sorted(tc) == sorted(jc)
        for key in jc:
            assert tuple(tc[key].shape) == jc[key].shape
            np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]),
                                       atol=ATOL, rtol=ATOL)


# --------------------------------------------------------------------------- #
# the archs at SMOKE size, the reference's parameters
# --------------------------------------------------------------------------- #
def _open_gates(jparams):
    """Every ``xgate`` of the tree set to XGATE (llama-vision)."""
    def put(path, leaf):
        names = [getattr(p, "key", None) for p in path]
        return jnp.full_like(leaf, XGATE) if "xgate" in names else leaf
    return jax.tree_util.tree_map_with_path(put, jparams)


@pytest.fixture(scope="module", params=NEW)
def models(request):
    arch = request.param
    jm = j_build(jreg.SMOKE[arch])
    jctx = JCtx(mesh=None, remat="none")
    jparams, _ = jm.init(jctx, jax.random.PRNGKey(0))
    jparams = _open_gates(jparams)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    return (arch, jm, jctx, jparams, build_model(registry.SMOKE[arch]),
            RunCtx(remat="none"), tparams)


def _batch(cfg, B=2, S=20, seed=0):
    """Tokens, targets and mask; seamless' frames or llama-vision's image
    embeddings (numpy, from a seed)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S + 1)).astype(np.int32)
    out = {"inputs": toks[:, :-1], "targets": toks[:, 1:],
           "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if cfg.n_enc_layers:
        out["frames"] = rng.normal(size=(B, S_ENC, cfg.d_model)).astype(
            np.float32)
    elif cfg.cross_kv_len:
        out["xkv"] = rng.normal(size=(B, cfg.cross_kv_len, cfg.d_model)
                                ).astype(np.float32)
    return out


def _j(batch, keys=None):
    return {k: jnp.asarray(v) for k, v in batch.items()
            if keys is None or k in keys}


def _t(batch, keys=None):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()
            if keys is None or k in keys}


def test_params_cross_with_the_reference_keys_and_dtypes(models):
    arch, jm, jctx, jparams, tm, ctx, tparams = models
    own = tm.init(ctx, torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jflat) == len(tree_leaves(own)) == len(tree_leaves(tparams))
    for (path, a), b in zip(jflat, tree_leaves(own)):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == _dtype_name(b.dtype), path
    assert ("enc" in own) == (arch == "seamless-m4t-medium")
    assert tm.enc_segments == (None if jm.enc_segments is None else [
        type(s)(j.unit, j.count) for s, j in zip(tm.enc_segments,
                                                 jm.enc_segments)])


def test_train_logits_loss_and_grads(models):
    arch, jm, jctx, jparams, tm, ctx, tparams = models
    batch = _batch(tm.cfg)
    want = jm.train_logits(jparams, jctx, _j(batch))
    got = tm.train_logits(tparams, ctx, _t(batch))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=ATOL)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.train_loss(p, jctx, _j(batch)))(jparams)
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tloss = tm.train_loss(tparams, ctx, _t(batch))
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=ATOL, rtol=ATOL)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tgrads)
    for (path, a), b in zip(jflat, tgrads):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL, err_msg=str(path))
    for t in leaves:
        t.requires_grad_(False)


def test_prefill_caches_and_decode_steps(models):
    """Prefill logits and caches (a cross sub-block's cache at the
    encoder's or image's length), then 4 decode steps with the
    reference's ``xkv=None`` (R1: the cross sub-block decodes down the
    self path over that cache) and every cache after them."""
    arch, jm, jctx, jparams, tm, ctx, tparams = models
    batch = _batch(tm.cfg)
    keys = ("inputs", "frames", "xkv")
    jl, jc = jm.prefill(jparams, jctx, _j(batch, keys), CACHE_LEN)
    tl, tc = tm.prefill(tparams, ctx, _t(batch, keys), CACHE_LEN)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL, rtol=ATOL)
    jleaves, tleaves = jax.tree.leaves(jc), tree_leaves(tc)
    assert [a.shape for a in jleaves] == [tuple(b.shape) for b in tleaves]
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=ATOL, rtol=ATOL)
    if tm.cfg.n_enc_layers or tm.cfg.cross_kv_len:
        enc_len = S_ENC if tm.cfg.n_enc_layers else tm.cfg.cross_kv_len
        assert enc_len in {b.shape[2] for b in tleaves}
    last = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
    pos = np.full((2,), 20, np.int32)
    for _ in range(4):
        jl, jc = jm.decode_step(jparams, jctx, jnp.asarray(last),
                                jnp.asarray(pos), jc)
        tl, tc = tm.decode_step(tparams, ctx, torch.from_numpy(last),
                                torch.from_numpy(pos), tc)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=ATOL,
                                   rtol=ATOL)
        last = np.argmax(np.asarray(jl), -1).astype(np.int32)[:, None]
        pos = pos + 1
    for a, b in zip(jax.tree.leaves(jc), tree_leaves(tc)):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=ATOL, rtol=ATOL)


def test_kv_block_struct_is_a_text_only_prefill(models):
    """The layout the servers' text-only prefill gives (``{"inputs"}``);
    the reference's prefill traced on the same batch gives the same
    shapes; an encoder-decoder has none (its prefill needs frames)."""
    arch, jm, jctx, jparams, tm, ctx, tparams = models
    if tm.cfg.n_enc_layers:
        with pytest.raises(ValueError, match="frames"):
            tm.kv_block_struct(ctx, 5, CACHE_LEN)
        with pytest.raises(KeyError, match="frames"):
            jax.eval_shape(lambda p: jm.prefill(
                p, jctx, {"inputs": jnp.zeros((1, 5), jnp.int32)}, CACHE_LEN),
                jparams)
        return
    for B in (1, 3):
        _, want = jax.eval_shape(lambda p: jm.prefill(
            p, jctx, {"inputs": jnp.zeros((B, 5), jnp.int32)}, CACHE_LEN),
            jparams)
        got = tree_leaves(tm.kv_block_struct(ctx, 5, CACHE_LEN, B))
        assert [tuple(s.shape) for s in jax.tree.leaves(want)] == [
            s.shape for s in got]
        assert [str(s.dtype) for s in jax.tree.leaves(want)] == [
            _dtype_name(s.dtype) for s in got]


def _requests(mod, vocab=512):
    """Two prompt lengths (19 is past gemma3's window of 16; few lengths,
    few reference compiles), a staggered max_new (rows die mid-run), two
    sharing a 16-token prefix."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, vocab, size=16).tolist()
    reqs = [mod.Request(rid=0, prompt=shared + [5, 6, 7], max_new=6),
            mod.Request(rid=1, prompt=shared + [9, 11, 13], max_new=3)]
    for rid, (n, m) in enumerate([(4, 7), (19, 2), (4, 5)], start=2):
        reqs.append(mod.Request(
            rid=rid, prompt=rng.integers(0, vocab, size=n).tolist(),
            max_new=m))
    return reqs


def _serve(server, reqs):
    for r in reqs:
        server.submit(r)
    stats = server.run_until_drained()
    return {r.rid: r.out for r in server.finished}, stats


SERVED = {"gemma3-27b": (False,), "granite-34b": (False, True),
          "llama3-405b": (False, True), "llama-3.2-vision-11b": (False,),
          "seamless-m4t-medium": ()}


def test_servers_match_reference_or_refuse(models):
    """``Server`` tokens equal the reference's for gemma3 (prompts past
    its window), granite, llama3 and llama-vision (text-only, as the
    reference's server passes only the tokens); ``PagedServer`` tokens
    for granite and llama3 (group 8 and 4 GQA through the paged kernel's
    plain version).  ``PagedServer`` refuses gemma3's ``local``,
    llama-vision's ``cross`` and seamless' ``xdec`` blocks, and
    ``Server`` refuses an encoder-decoder with a pointer to
    ``Model.prefill``."""
    arch, jm, jctx, jparams, tm, ctx, tparams = models
    for paged in SERVED[arch]:
        if paged:
            want, _ = _serve(jserve.PagedServer(jm, jctx, jparams, 3, CACHE_LEN,
                                                page_tokens=8),
                             _requests(jserve))
            server = serve.PagedServer(tm, ctx, tparams, 3, CACHE_LEN,
                                       device="cpu", page_tokens=8)
        else:
            want, _ = _serve(jserve.Server(jm, jctx, jparams, 3, CACHE_LEN),
                             _requests(jserve))
            server = serve.Server(tm, ctx, tparams, 3, CACHE_LEN, device="cpu")
        got, stats = _serve(server, _requests(serve))
        assert got == want and len(got) == 5, (arch, paged)
        if paged:
            assert stats["pool_prefix_hits"] >= 2
            assert stats["pool_n_free"] == stats["pool_n_pages"]
    if True not in SERVED[arch]:
        with pytest.raises(ValueError, match="paged decode unsupported"):
            serve.PagedServer(tm, ctx, tparams, 3, CACHE_LEN, device="cpu",
                              page_tokens=8)
    if arch == "seamless-m4t-medium":
        with pytest.raises(ValueError, match="Model.prefill"):
            serve.Server(tm, ctx, tparams, 3, CACHE_LEN, device="cpu")
        with pytest.raises(KeyError, match="frames"):
            _serve(jserve.Server(jm, jctx, jparams, 3, CACHE_LEN),
                   _requests(jserve)[:1])


@pytest.mark.parametrize("arch", NEW)
def test_launch_serve_and_train_run_on_cpu(arch, capsys, monkeypatch):
    """``launch/serve.py`` serves each new arch on the CPU (paged where
    the blocks allow; seamless through ``Model.prefill`` with frames) and
    ``launch/train.py`` takes 2 steps of it."""
    from repro_torch.launch import train

    args = ["--role", "decode", "--arch", arch, "--device", "cpu",
            "--requests", "3", "--batch", "2", "--max-new", "3"]
    if True in SERVED[arch]:
        args.append("--paged")
    serve.main(args)
    out = capsys.readouterr().out
    assert "requests: 3" in out
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
        "--seq", "16", "--device", "cpu"])
    train.main()
    out = capsys.readouterr().out
    assert "final loss:" in out
    loss = float(out.split("final loss:")[1].split()[0])
    assert np.isfinite(loss)
