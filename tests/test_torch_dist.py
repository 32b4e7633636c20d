"""Training on the GAS layer, on the CPU, against the JAX reference.

The int8 error-feedback compression bit for bit (``optim/compression.py``;
the ring on "xla", "gascore" and "xla,gascore" against the reference's
ring under ``repro.testing.sim.run_spmd``); the transport ops' VJPs by
``gradcheck`` in f64 (the GAScore transport forward-only); GPipe forward
and backward (``parallel/pipeline.py``) against ``jax.grad`` of the
reference's sequential chain, segmented boundaries and ``pipelined(remat=
True)`` among them; one ``train_lm.make_step`` per reduce mode against the
JAX composition of per-rank ``jax.grad(model.train_loss)``, the mean over
ranks and ``adamw.apply_updates``; ``train_lm``'s failure and elastic
restart; and ``testing/dist_suite.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import SMOKE as J_SMOKE
from repro.models.build import build_model as j_build
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.parallel.ctx import RunCtx as JCtx
from repro.testing import sim as jsim
from repro_torch.compat import tree_leaves, tree_map
from repro_torch.configs.registry import SMOKE
from repro_torch.core import gasnet, transport
from repro_torch.core.gasnet import P
from repro_torch.examples import train_lm
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.optim import adamw, compression
from repro_torch.parallel.pipeline import gpipe, pipelined
from repro_torch.testing import dist_suite

BACKENDS = ("xla", "gascore", "xla,gascore")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many small ops; with one intra-op thread they do
    not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed):
    return np.random.default_rng(seed)


# --------------------------------------------------------------------------- #
# int8 error-feedback compression
# --------------------------------------------------------------------------- #
def test_quantize_and_ef_prepare_bitwise():
    g = _rng(0).normal(size=(4096,)).astype(np.float32)
    err = (_rng(1).normal(size=(4096,)) * 1e-2).astype(np.float32)
    # exact halves of the scale (127 at the max): round half to even
    g[:8] = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 126.5, 127.0],
                     np.float32) * (4.0 / 127.0)
    g[8] = 4.0
    err[:9] = 0.0
    jq, js = jcomp.quantize_int8(jnp.asarray(g))
    tq, ts = compression.quantize_int8(torch.from_numpy(g))
    assert tq.dtype == torch.int8 and np.array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    assert np.array_equal(tq[:8].numpy(), [0, 2, 2, 0, -2, 4, 126, 127])
    np.testing.assert_array_equal(
        compression.dequantize_int8(tq, ts).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js)))
    jout = jcomp.ef_prepare(jnp.asarray(g), jnp.asarray(err))
    tout = compression.ef_prepare(torch.from_numpy(g), torch.from_numpy(err))
    for a, b in zip(tout, jout):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # all zeros: the scale floors at 1e-12 / 127
    zq, zs = compression.quantize_int8(torch.zeros(5))
    assert float(zs) == np.float32(1e-12) / np.float32(127.0)
    assert not zq.any()


def _ring_reference(x, err):
    n = x.shape[0]
    outs = jsim.run_spmd(lambda eng: jcomp.compressed_ring_all_reduce(
        eng, jnp.asarray(x[eng.rank]), jnp.asarray(err[eng.rank])), n)
    return (np.stack([np.asarray(o[0]) for o in outs]),
            np.stack([np.asarray(o[1]) for o in outs]))


@pytest.mark.parametrize("backend", BACKENDS)
def test_compressed_ring_all_reduce_bitwise(backend):
    n, L = 4, 256
    x = _rng(2).normal(size=(n, L)).astype(np.float32)
    err = (_rng(3).normal(size=(n, L)) * 1e-2).astype(np.float32)
    jred, jerr = _ring_reference(x, err)
    ctx = gasnet.Context(n, backend=backend, device="cpu")
    red, new_err = ctx.spmd(
        lambda node, xl, el: compression.compressed_ring_all_reduce(
            node.engine, xl, el),
        torch.from_numpy(x.reshape(-1)), torch.from_numpy(err.reshape(-1)),
        out_specs=(P("node"), P("node")))
    assert np.array_equal(red.reshape(n, L).numpy(), jred)
    assert np.array_equal(new_err.reshape(n, L).numpy(), jerr)
    # every rank holds the same reduced vector, within 5% of the exact sum
    assert (red.reshape(n, L) == red[:L]).all()
    want = x.sum(0)
    assert np.abs(jred[0] - want).max() / np.abs(want).max() < 0.05
    with pytest.raises(ValueError, match="divisible"):
        ctx.spmd(lambda node, xl: compression.compressed_ring_all_reduce(
            node.engine, xl, xl)[0], torch.zeros(n * 5))


def test_compressed_tree_and_error_state_bitwise():
    n = 4
    rng = _rng(4)
    trees = [{"a": rng.normal(size=(3, 5)).astype(np.float32),
              "b": [rng.normal(size=(7,)).astype(np.float32)]}
             for _ in range(n)]
    jerr0 = jcomp.init_error_state(jax.tree.map(jnp.asarray, trees[0]), n)
    terr0 = compression.init_error_state(tree_map(torch.from_numpy,
                                                  trees[0]), n)
    assert tuple(terr0.shape) == jerr0.shape == (24,)
    assert terr0.dtype == torch.float32 and not terr0.any()
    outs = jsim.run_spmd(lambda eng: jcomp.compressed_all_reduce_tree(
        eng, jax.tree.map(jnp.asarray, trees[eng.rank]), jerr0), n)
    stacked = {"a": torch.from_numpy(np.concatenate([t["a"] for t in trees])),
               "b": [torch.from_numpy(np.concatenate([t["b"][0]
                                                      for t in trees]))]}
    ctx = gasnet.Context(n, backend="xla", device="cpu")
    got, new_err = ctx.spmd(
        lambda node, tr: compression.compressed_all_reduce_tree(
            node.engine, tr, terr0),
        stacked, out_specs=(P("node"), P("node")))
    for r in range(n):
        jtree, jerr = outs[r]
        np.testing.assert_array_equal(got["a"][3 * r:3 * r + 3].numpy(),
                                      np.asarray(jtree["a"]))
        np.testing.assert_array_equal(got["b"][0][7 * r:7 * r + 7].numpy(),
                                      np.asarray(jtree["b"][0]))
        np.testing.assert_array_equal(new_err[24 * r:24 * r + 24].numpy(),
                                      np.asarray(jerr))


# --------------------------------------------------------------------------- #
# the transport ops' VJPs
# --------------------------------------------------------------------------- #
PROGRAMS = {
    "shift": lambda e, x: e.shift(x, 3),
    "permute": lambda e, x: e.permute(x, [2, None, 0, 1]),
    "all_reduce": lambda e, x: e.all_reduce(x),
    "all_gather": lambda e, x: e.all_gather(x),
    "reduce_scatter": lambda e, x: e.reduce_scatter(x),
    "all_to_all": lambda e, x: e.all_to_all(x),
    "split_phase": lambda e, x: e.shift_nb(x * x, 1).wait()
    + e.permute_nb(x, [1, 2, 3, 0]).wait(),
}


@pytest.mark.parametrize("op", sorted(PROGRAMS))
def test_transport_vjps_by_gradcheck(op):
    n = 4
    ctx = gasnet.Context(n, backend="xla", device="cpu")
    x = torch.from_numpy(_rng(5).normal(size=(n * 4, 1))).requires_grad_()

    def f(t):
        return ctx.spmd(lambda node, xl: PROGRAMS[op](node.engine, xl), t)

    assert torch.autograd.gradcheck(f, (x,))
    # the GAScore transport is forward-only, as the reference's Pallas path
    gctx = gasnet.Context(n, backend="gascore", device="cpu")
    prog = PROGRAMS[op] if op != "permute" else (
        lambda e, xl: e.permute(xl, [2, 3, 0, 1]))
    y = gctx.spmd(lambda node, xl: prog(node.engine, xl), x)
    with pytest.raises(RuntimeError, match="forward-only"):
        y.sum().backward()


def test_transport_without_grad_records_nothing():
    ctx = gasnet.Context(4, backend="xla", device="cpu")
    x = torch.ones(8, requires_grad=True)
    with torch.no_grad():
        y = ctx.spmd(lambda node, xl: node.engine.shift(xl, 1), x)
    assert y.grad_fn is None and transport.BACKENDS == ("xla", "gascore")


# --------------------------------------------------------------------------- #
# GPipe
# --------------------------------------------------------------------------- #
S, M, MB, D = 4, 6, 4, 8


def _pipe_inputs():
    xm = _rng(1).normal(size=(M, MB, D)).astype(np.float32)
    w = (_rng(2).normal(size=(S, D, D)) * 0.3).astype(np.float32)
    return xm, w


def _jax_chain(w, xm):
    def loss(wl, xs):
        o = xs
        for i in range(S):
            o = jnp.tanh(o @ wl[i])
        return (o ** 2).sum(), o

    (_, out), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(w),
                                                         jnp.asarray(xm))
    return np.asarray(out), np.asarray(g)


def _stage(wl, xx):
    return torch.tanh(xx @ wl[0])


@pytest.mark.parametrize("segments,remat", [(None, False), (1, True),
                                            (3, False), (2, True)])
def test_gpipe_matches_the_reference_chain(segments, remat):
    xm, w = _pipe_inputs()
    jout, jgrad = _jax_chain(w, xm)
    ctx = gasnet.Context(S, backend="xla", device="cpu")
    fn = pipelined(_stage, ctx=ctx, n_micro=M, remat=remat,
                   boundary_segments=segments)
    tw = torch.from_numpy(w).requires_grad_()
    out = fn(tw, torch.from_numpy(xm))
    np.testing.assert_allclose(out.detach().numpy(), jout, atol=1e-5, rtol=0)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), jgrad, atol=2e-4, rtol=2e-4)


def test_gpipe_gascore_forward_equals_xla_and_has_no_gradient():
    xm, w = _pipe_inputs()
    outs = {}
    for backend in ("xla", "gascore", "xla,gascore"):
        ctx = gasnet.Context(S, backend=backend, device="cpu")
        tw = torch.from_numpy(w).requires_grad_()
        outs[backend] = ctx.spmd(
            lambda node, wl, xs: gpipe(_stage, wl, xs, engine=node.engine,
                                       n_stages=S),
            tw, torch.from_numpy(xm), in_specs=(P("node"), P()),
            out_specs=P())
        if backend != "xla":
            with pytest.raises(RuntimeError, match="forward-only"):
                outs[backend].sum().backward()
    assert torch.equal(outs["gascore"], outs["xla"])
    assert torch.equal(outs["xla,gascore"], outs["xla"])
    # without broadcast_out only the last stage holds the outputs
    ctx = gasnet.Context(S, backend="xla", device="cpu")
    last = ctx.spmd(
        lambda node, wl, xs: gpipe(_stage, wl, xs, engine=node.engine,
                                   n_stages=S, broadcast_out=False),
        torch.from_numpy(w), torch.from_numpy(xm),
        in_specs=(P("node"), P()), out_specs=P("node")).reshape(S, M, MB, D)
    assert torch.equal(last[-1], outs["xla"].detach())
    assert not last[:-1].any()


def test_dist_suite_gpipe_at_the_reference_shapes():
    out, grad = dist_suite.gpipe_parity(torch.device("cpu"),
                                        boundary_segments=2)
    assert out.shape == (dist_suite.M, dist_suite.MB, dist_suite.D)
    assert torch.isfinite(grad).all()


# --------------------------------------------------------------------------- #
# data-parallel training: make_step per reduce mode
# --------------------------------------------------------------------------- #
N_RANKS, BATCH, SEQ = 4, 4, 16


def _dp_batch():
    rng = _rng(6)
    toks = rng.integers(0, 512, size=(BATCH, SEQ + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:],
            "mask": np.ones((BATCH, SEQ), np.float32)}


@pytest.fixture(scope="module")
def dp_reference():
    """The reference's parameters and each rank's loss and gradients on
    its shard (its local step: remat "none")."""
    jm = j_build(J_SMOKE["qwen3-4b"])
    jparams = jax.jit(lambda k: jm.init(JCtx(mesh=None), k)[0])(
        jax.random.PRNGKey(0))
    jctx = JCtx(mesh=None, remat="none")
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jm.train_loss(p, jctx, b)))
    batch, per = _dp_batch(), BATCH // N_RANKS
    losses, grads = [], []
    for r in range(N_RANKS):
        loss, g = grad_fn(jparams, {k: jnp.asarray(v[r * per:(r + 1) * per])
                                    for k, v in batch.items()})
        losses.append(loss)
        grads.append(g)
    return jparams, grads, float(sum(losses) / N_RANKS)


def _jax_step(jparams, grads, opt):
    """The reference's composition after the local grads: their mean over
    the ranks, then AdamW."""
    mean = jax.tree.map(lambda *gs: sum(gs) / N_RANKS, *grads)
    params, _, _ = jax.jit(lambda p, g: jadamw.apply_updates(
        p, g, jadamw.init_state(p, opt), opt))(jparams, mean)
    return params, mean


@pytest.mark.parametrize("mode", train_lm.REDUCE_MODES)
def test_make_step_matches_the_reference_composition(dp_reference, mode):
    jparams, jgrads, jloss = dp_reference
    kw = dict(lr=3e-3, weight_decay=0.0)
    jopt = jadamw.AdamWConfig(schedule=jadamw.warmup_cosine(3e-3, 10, 20), **kw)
    topt = adamw.AdamWConfig(schedule=adamw.warmup_cosine(3e-3, 10, 20), **kw)
    want, jmean = _jax_step(jparams, jgrads, jopt)

    tm = build_model(SMOKE["qwen3-4b"])
    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_jax(jax.tree.map(np.asarray, jparams)))
    tb = {k: torch.from_numpy(v) for k, v in _dp_batch().items()}
    # the reduced gradients, as the step's reduction makes them
    losses, stacked = train_lm.local_grads(tm, params, tb, N_RANKS,
                                           flat=mode != "psum")
    err = (train_lm.init_error(params, N_RANKS)
           if mode == "gas_ring_int8" else None)
    red, new_err = train_lm.reduce_grads(stacked, err, n_nodes=N_RANKS,
                                         reduce_mode=mode)
    jflat = np.concatenate([np.asarray(g).reshape(-1)
                            for g in jax.tree.leaves(jmean)])
    tflat = (torch.cat([g.reshape(-1) for g in red]) if mode == "psum"
             else red[:jflat.size]).numpy()
    scale = np.abs(jflat).max()
    # f32 summation order through 4 layers; the int8 ring (held bit for
    # bit to the reference's ring above) against the exact mean: its
    # quantization error, half a step (1/254 of the largest |value|) per
    # quantization, n of them along a chunk's way and one more to gather
    tol = 1e-5 if mode != "gas_ring_int8" else (N_RANKS + 1) / 254
    assert np.abs(tflat - jflat).max() <= tol * scale
    if mode == "gas_ring_int8":
        assert tuple(new_err.shape) == (N_RANKS, err.shape[1])
    assert abs(float(losses.mean()) - jloss) <= 1e-5 * abs(jloss)

    step = train_lm.make_step(tm, topt, N_RANKS, mode)
    params, state, err, metrics = step(params, adamw.init_state(params, topt),
                                       err, tb)
    assert abs(float(metrics["loss"]) - jloss) <= 1e-5 * abs(jloss)
    assert int(state["step"]) == 1
    # one AdamW step moves each element by about lr * sign(g): elements
    # whose reduced gradient differs near zero may move apart by 2 lr
    lr = 3e-3 / 10
    diffs = [np.abs(a.detach().numpy() - np.asarray(b))
             for a, b in zip(tree_leaves(params), jax.tree.leaves(want))]
    worst = max(float(d.max()) for d in diffs)
    far = sum(int((d > 1e-6).sum()) for d in diffs)
    assert worst <= 2.01 * lr
    if mode != "gas_ring_int8":
        assert far <= 1e-3 * sum(d.size for d in diffs)


def test_make_step_refuses_an_uneven_batch():
    tm = build_model(SMOKE["qwen3-4b"])
    params = tm.init(train_lm.LOCAL_CTX, torch.Generator().manual_seed(0),
                     device="cpu")
    params = tree_map(lambda t: t.requires_grad_(), params)
    opt = adamw.AdamWConfig()
    step = train_lm.make_step(tm, opt, 3, "psum")
    tb = {k: torch.from_numpy(v) for k, v in _dp_batch().items()}
    with pytest.raises(ValueError, match="divisible"):
        step(params, adamw.init_state(params, opt), None, tb)
    with pytest.raises(ValueError, match="reduce mode"):
        train_lm.make_step(tm, opt, 4, "allreduce")


# --------------------------------------------------------------------------- #
# the failure, the elastic restart and the suite
# --------------------------------------------------------------------------- #
def test_train_lm_main_restarts_on_the_survivors(capsys, tmp_path):
    train_lm.main(["--device", "cpu", "--steps", "4", "--fail-at", "3",
                   "--ckpt-every", "2", "--batch", "24", "--seq", "8",
                   "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "NODE FAILURE: nodes [6, 7] lost" in out
    assert ("restart: failed at step 3, restored step 2 on 6 nodes, params "
            "and AdamW state bitwise the snapshot's: True") in out
    assert "step    3" in out


def test_dist_suite_main_passes(capsys):
    dist_suite.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == "DIST_SUITE_PASS"
    assert "elastic restart OK" in out
