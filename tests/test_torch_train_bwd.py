"""Training the recurrent and MoE families through the port's backward
routes, against the JAX reference, on the CPU.

The port trains the scans through ``SelectiveScan`` / ``GatedLinearScan``
and the router's weights through ``repro_torch::router_weights``, whose
backward on the card is a hand kernel each (``csrc/ssm_scan_bwd.cu``,
``csrc/rglru_bwd.cu``, ``csrc/moe_router_bwd.cu``) and on the CPU the
plain formulas of ``kernels/ref.py``.  Here: each plain backward against
``jax.vjp`` of the reference's oracle; every parameter's gradient of
``train_loss`` at SMOKE size for falcon-mamba-7b and recurrentgemma-9b,
and the router's for kimi-k2 and arctic (local, and expert-parallel on
"xla"), against ``jax.grad`` of the reference with the same weights
(crossed by value through numpy); and a ``meta`` train step counting one backward op a
layer, as the card launches one.  Inputs are numpy, from seeds.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import SMOKE as J_SMOKE
from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro.models.build import build_model as j_build
from repro.parallel.ctx import RunCtx as JCtx
from repro_torch.compat import tree_leaves, tree_map
from repro_torch.configs.registry import SMOKE, ShapeConfig
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun, hlostats
from repro_torch.models import layers
from repro_torch.models.build import build_model
from repro_torch.parallel.ctx import RunCtx

# f32 on both sides; the plain backward sums in another order than XLA's
# autodiff of the lax.scan oracle (summation order only)
VJP_TOL = 2e-5
# gradients through 3-5 SMOKE layers: the same f32 order differences as
# tests/test_torch_zoo.py's (its GRAD_ATOL)
GRAD_ATOL = 2e-4


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=tol,
                               rtol=tol)


# --------------------------------------------------------------------------- #
# the plain backward formulas against jax.vjp of the reference's oracles
# --------------------------------------------------------------------------- #
def _ssm_args(B, S, Di, N, seed):
    """The model's value ranges: dt in [1e-3, 1e-1], A < 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, Di)).astype(np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), size=(B, S, Di))
                ).astype(np.float32)
    a = -np.exp(rng.normal(size=(Di, N))).astype(np.float32)
    b = rng.normal(size=(B, S, N)).astype(np.float32)
    c = rng.normal(size=(B, S, N)).astype(np.float32)
    d = rng.normal(size=(Di,)).astype(np.float32)
    dy = rng.normal(size=(B, S, Di)).astype(np.float32)
    return x, dt, a, b, c, d, dy


@pytest.mark.parametrize("B,S,Di,N,chunk", [
    (2, 37, 24, 8, 16),   # S not a multiple of the chunk
    (1, 64, 16, 16, 16),  # whole chunks, falcon-mamba's N
    (2, 5, 8, 4, 64),     # one chunk longer than S
])
def test_selective_scan_bwd_matches_jax_vjp(B, S, Di, N, chunk):
    *args, dy = _ssm_args(B, S, Di, N, seed=S + Di)
    _, vjp = jax.vjp(jref.selective_scan, *map(jnp.asarray, args))
    want = vjp(jnp.asarray(dy))
    got = ref.selective_scan_bwd(*map(torch.from_numpy, args),
                                 torch.from_numpy(dy), chunk=chunk)
    assert [g.dtype for g in got] == [torch.float32] * 6
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, want):
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=VJP_TOL,
                                   atol=VJP_TOL * scale, err_msg=name)
    exact = ref.selective_scan_bwd(*map(torch.from_numpy, args),
                                   torch.from_numpy(dy), chunk=chunk,
                                   acc=torch.float64)
    assert all(g.dtype == torch.float64 for g in exact)


@pytest.mark.parametrize("B,S,W", [(2, 33, 16), (1, 1, 8), (3, 64, 40)])
def test_gated_linear_scan_bwd_matches_jax_vjp(B, S, W):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.1, 0.99, size=(B, S, W)).astype(np.float32)
    b = rng.normal(size=(B, S, W)).astype(np.float32)
    dh = rng.normal(size=(B, S, W)).astype(np.float32)
    h, vjp = jax.vjp(jref.gated_linear_scan, jnp.asarray(a), jnp.asarray(b))
    want = vjp(jnp.asarray(dh))
    got = ref.gated_linear_scan_bwd(torch.from_numpy(a),
                                    torch.from_numpy(np.array(h)),
                                    torch.from_numpy(dh))
    for g, w in zip(got, want):
        _close(g, w, VJP_TOL)
    # bf16 inputs: f32 inside, the results in the inputs' dtype
    da, db = ref.gated_linear_scan_bwd(
        *(torch.from_numpy(t).bfloat16() for t in (a, np.array(h), dh)))
    assert da.dtype == db.dtype == torch.bfloat16


def _tied_logits(T, E, seed):
    """Random logits, with rows of repeated values (the tie rule)."""
    lg = np.random.default_rng(seed).normal(size=(T, E)).astype(np.float32)
    lg[1] = 0.5
    lg[3, : E // 2] = 1.25
    lg[5, ::2] = -0.75
    return lg


@pytest.mark.parametrize("renormalize", [True, False])
@pytest.mark.parametrize("T,E,K", [(16, 8, 2), (24, 64, 8)])
def test_route_topk_bwd_matches_jax_vjp(T, E, K, renormalize):
    lg = _tied_logits(T, E, seed=T + E)
    dw = np.random.default_rng(K).normal(size=(T, K)).astype(np.float32)
    kw = dict(k=K, capacity=4, renormalize=renormalize)
    w, vjp = jax.vjp(lambda x: jref.route_topk(x, **kw)[2], jnp.asarray(lg))
    (want,) = vjp(jnp.asarray(dw))
    e = jref.route_topk(jnp.asarray(lg), **kw)[0]
    got = ref.route_topk_bwd(torch.from_numpy(lg),
                             torch.from_numpy(np.asarray(e)),
                             torch.from_numpy(dw), renormalize=renormalize)
    assert got.dtype == torch.float32 and got.shape == (T, E)
    _close(got, want, VJP_TOL)


# --------------------------------------------------------------------------- #
# the routes: which Function each entry point takes when a gradient is due
# --------------------------------------------------------------------------- #
def test_entry_points_take_the_backward_routes_when_a_gradient_is_due():
    *args, _ = _ssm_args(1, 9, 8, 4, seed=1)
    t = [torch.from_numpy(x).requires_grad_() for x in args]
    assert type(ops.selective_scan(*t).grad_fn).__name__ == \
        "SelectiveScanBackward"
    y, h = ops.selective_scan(*t, final_state=True)  # the plain path
    assert y.requires_grad and h.requires_grad
    with torch.no_grad():
        assert ops.selective_scan(*t).grad_fn is None
    a = torch.rand((1, 9, 8)).requires_grad_()
    assert type(ops.gated_linear_scan(a, a).grad_fn).__name__ == \
        "GatedLinearScanBackward"
    lg = torch.from_numpy(_tied_logits(6, 8, 0)).requires_grad_()
    e, s, w, keep = ops.moe_router(lg, k=2, capacity=4)
    assert w.grad_fn is not None and not e.requires_grad
    want = ref.route_topk(lg.detach(), k=2, capacity=4)
    for g, x in zip((e, s, w, keep), want):
        assert torch.equal(g, x)
    (g,) = torch.autograd.grad(w.sum() + (w ** 2).sum(), lg)
    torch.testing.assert_close(g, ref.route_topk_bwd(
        lg.detach(), e, 1 + 2 * w.detach()), rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# whole models at SMOKE size against jax.grad of the reference
# --------------------------------------------------------------------------- #
def _cross(jinit, tparams):
    """The port's parameters as the reference's tree (the structure from
    ``jax.eval_shape`` of the reference's init, leaves by value through
    numpy, in the order both packages flatten them)."""
    jleaves, treedef = jax.tree.flatten(jax.eval_shape(
        jinit, jax.random.PRNGKey(0)))
    leaves = tree_leaves(tparams)
    assert [tuple(a.shape) for a in jleaves] == [tuple(t.shape)
                                                 for t in leaves]
    return jax.tree.unflatten(treedef, [jnp.asarray(t.numpy())
                                        for t in leaves])


def _models(arch, **changes):
    """Both packages' models at ``arch``'s SMOKE size (with ``changes`` to
    its config on both sides), and the port's weights crossed into the
    reference's tree."""
    jm = j_build(dataclasses.replace(J_SMOKE[arch], **changes))
    jctx = JCtx(mesh=None, remat="none")
    tm = build_model(dataclasses.replace(SMOKE[arch], **changes))
    tparams = tm.init(RunCtx(), torch.Generator().manual_seed(0),
                      device="cpu")
    jparams = _cross(lambda k: jm.init(jctx, k)[0], tparams)
    return jm, jctx, jparams, tm, tparams


def _batch(vocab, B=2, S=20, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:],
            "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}


def _counting(monkeypatch, name):
    """Count the calls of ``ref.<name>`` (the plain backward the CPU
    route runs)."""
    calls = []
    fn = getattr(ref, name)

    def counted(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(ref, name, counted)
    return calls


@pytest.mark.parametrize("arch,kind,bwd", [
    ("falcon-mamba-7b", "mamba", "selective_scan_bwd"),
    ("recurrentgemma-9b", "rec", "gated_linear_scan_bwd"),
])
def test_train_grads_match_reference(arch, kind, bwd, monkeypatch):
    """Every parameter's gradient of ``train_loss`` (remat off on both
    sides) against ``jax.grad``; the plain backward ran once a layer of
    its kind."""
    jm, jctx, jparams, tm, tparams = _models(arch)
    batch = _batch(tm.cfg.vocab)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.train_loss(
        p, jctx, {k: jnp.asarray(v) for k, v in batch.items()}))(jparams)
    calls = _counting(monkeypatch, bwd)
    leaves = [t.requires_grad_() for t in tree_leaves(tparams)]
    tloss = tm.train_loss(tparams, RunCtx(remat="none"), {
        k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, leaves)
    assert len(calls) == tm.cfg.layer_kinds().count(kind)
    _close(tloss, jloss, GRAD_ATOL)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tgrads)
    for (path, a), b in zip(jflat, tgrads):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL, err_msg=str(path))


def test_train_grads_head_dim_256_local_layer(monkeypatch):
    """recurrentgemma-9b at SMOKE widths but its own head dim of 256, on
    one (rec, rec, local) group: the local layer's attention goes through
    ``FlashAttention`` (its plain backward on the CPU, as the card runs
    the D-256 kernels) with a window of 16 under S 20.  The loss and
    every parameter's gradient against ``jax.grad`` of the reference."""
    jm, jctx, jparams, tm, tparams = _models("recurrentgemma-9b",
                                             head_dim=256, n_layers=3)
    assert tm.cfg.layer_kinds() == ["rec", "rec", "local"]
    batch = _batch(tm.cfg.vocab)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.train_loss(
        p, jctx, {k: jnp.asarray(v) for k, v in batch.items()}))(jparams)
    calls = _counting(monkeypatch, "flash_attention_dq")
    leaves = [t.requires_grad_() for t in tree_leaves(tparams)]
    tloss = tm.train_loss(tparams, RunCtx(remat="none"), {
        k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    tgrads = torch.autograd.grad(tloss, leaves)
    assert len(calls) == 1
    _close(tloss, jloss, GRAD_ATOL)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tgrads)
    for (path, a), b in zip(jflat, tgrads):
        np.testing.assert_allclose(_np(b), np.asarray(a), atol=GRAD_ATOL,
                                   rtol=GRAD_ATOL, err_msg=str(path))


def _reference_moe(jp, jcfg, x2d, shards):
    """sum(y^2) of the reference's MoE body over ``shards`` token shards
    (each with its own capacity, as ``_moe_ep`` routes them): the
    reference's local path at one shard."""
    T = x2d.shape[0]
    T_l = T // shards
    C_l = max(4, int(math.ceil(T_l * jcfg.top_k * jcfg.capacity_factor
                               / jcfg.n_experts)))
    act = jlayers._act(jcfg.act)
    total = 0.0
    for i in range(shards):
        x_l = x2d[i * T_l:(i + 1) * T_l]
        e, s, w, keep = jref.route_topk(x_l @ jp["router"], k=jcfg.top_k,
                                        capacity=C_l, renormalize=True)
        buf = jref.moe_dispatch(x_l, e, s, keep, n_experts=jcfg.n_experts,
                                capacity=C_l)
        hid = act(jnp.einsum("ecd,edf->ecf", buf, jp["wg"])) * jnp.einsum(
            "ecd,edf->ecf", buf, jp["wi"])
        out = jref.moe_combine(jnp.einsum("ecf,efd->ecd", hid, jp["wo"]),
                               e, s, w, keep)
        total = total + (out ** 2).sum()
    return total


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "arctic-480b"])
@pytest.mark.parametrize("grid", [None, (2, 4)])
def test_router_grad_local_and_ep_match_reference(arch, grid):
    """The router's gradient of sum(y^2) of one MoE layer, local and
    expert-parallel on "xla" (8 token shards), against ``jax.grad`` of the
    reference's body with the same shards and capacities."""
    jcfg = J_SMOKE[arch]
    tcfg = SMOKE[arch]
    tp = layers.moe_init(tcfg, RunCtx(), torch.Generator().manual_seed(1))
    jp = _cross(lambda k: jlayers.moe_init(jcfg, JCtx(mesh=None), k)[0], tp)
    keys = ("router", "wi", "wg", "wo")
    x = (np.random.default_rng(3).normal(size=(64, tcfg.d_model)) * 0.1
         ).astype(np.float32)
    shards = 1 if grid is None else grid[0] * grid[1]
    want = jax.grad(lambda r: _reference_moe(
        {**jp, "router": r}, jcfg, jnp.asarray(x), shards))(jp["router"])
    p = {k: tp[k].clone().requires_grad_() for k in keys}
    if grid is None:
        y = layers._moe_local(p, tcfg, RunCtx(), torch.from_numpy(x),
                              layers.moe_capacity(tcfg, 64))
    else:
        y = layers._moe_ep(p, tcfg, RunCtx(moe_mode="ep_shardmap",
                                           ep_grid=grid),
                           torch.from_numpy(x))
    (got,) = torch.autograd.grad((y ** 2).sum(), [p["router"]])
    assert float(np.abs(np.asarray(want)).max()) > 0
    _close(got, want, GRAD_ATOL)


# --------------------------------------------------------------------------- #
# the dry run counts what the card runs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,kind,name", [
    ("falcon-mamba-7b", "mamba", "selective_scan"),
    ("recurrentgemma-9b", "rec", "gated_linear_scan"),
    ("arctic-480b", "moe", "moe_router"),
])
def test_meta_train_step_counts_one_backward_op_a_layer(arch, kind, name):
    """A SMOKE train step as the dry run makes it (full remat) on
    ``meta``: each scan or router layer one backward op and two forwards
    (the step's and the recomputation's), as on the card."""
    cfg = SMOKE[arch]
    model = build_model(cfg)
    ctx = dryrun.build_ctx(dryrun.mesh_of("h100"))
    opt = dryrun.opt_config(model)
    shape = ShapeConfig("t", "train", 16, 2)
    structs, _ = dryrun.step_structs(model, ctx, shape, opt)
    step = dryrun.make_step(model, ctx, shape, opt)
    st = hlostats.analyze(step, *dryrun.meta_args(structs, shape.kind))
    n = cfg.layer_kinds().count(kind)
    assert n > 0
    assert st.kernels[f"{name}_bwd"] == n
    assert st.kernels[name] == 2 * n


def test_meta_router_bwd_is_one_op_under_the_rank_vmap():
    """The router's backward under expert parallelism: one op for the
    group, the ranks folded into the rows, with a gradient for every
    rank's rows."""
    cfg = SMOKE["arctic-480b"]
    ctx = RunCtx(moe_mode="ep_shardmap", ep_grid=(1, 4))
    p = layers.moe_init(cfg, ctx, torch.Generator().manual_seed(0))
    p = tree_map(lambda t: t.requires_grad_(), p)
    x = torch.randn((32, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)) * 0.1
    with hlostats.OpCounter() as counter:
        y = layers._moe_ep(p, cfg, ctx, x)
        (g,) = torch.autograd.grad((y ** 2).sum(), [p["router"]])
    assert counter.stats().kernels["moe_router_bwd"] == 1
    assert bool((g != 0).any())


def test_backward_bounds_are_perf_md_bound_column():
    """The bounds of ``PERF.md`` §6's rows 10b-12b, from the work formulas
    of ``kernels/cost.py`` that ``chip_smoke.py`` prices them with, in
    µs: the selective scan's backward at falcon-mamba's training shape
    (bf16 by operations, f32 by bytes), the RG-LRU's at recurrentgemma's
    (bytes), the router's at kimi-k2's widths (bytes)."""
    from repro_torch.kernels import cost

    def us(name, case, dtype=torch.float32, router=False):
        work = (cost.router_bwd_work(*case) if router
                else cost.scan_work(name, case, dtype))
        b = cost.bound(*work, torch.float32)
        return round(1e3 * b["bound_ms"], 3), b["bound_by"]

    ssm = (1, 4096, 8192, 16)
    assert us("selective_scan_bwd", ssm, torch.bfloat16) == (156.754,
                                                             "operations")
    assert us("selective_scan_bwd", ssm) == (200.971, "bytes")
    lru = (1, 4096, 4096)
    assert us("gated_linear_scan_bwd", lru) == (100.162, "bytes")
    assert us("gated_linear_scan_bwd", lru, torch.bfloat16) == (50.081,
                                                                "bytes")
    assert [us("", (T, 384, 8), router=True)[0] for T in (8, 128, 8192)] == [
        0.007, 0.12, 7.669]
    assert cost.exponentials("selective_scan_bwd", ssm) == 8192 * 4096 * 16
