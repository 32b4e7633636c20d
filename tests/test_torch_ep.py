"""Expert-parallel MoE of the port against the JAX reference, on the CPU.

The reference's ``_moe_ep`` runs under ``shard_map`` on a (data, model)
mesh, which needs several XLA devices (those runs abort in the CPU
rendezvous here), so the port's EP is held to the reference's EP body
composed on ONE JAX device, token shard by token shard: ``kref.route_topk``
with the shard's capacity ``C_l``, ``kref.moe_dispatch``, the expert
einsums and ``kref.moe_combine`` (the all-to-all only moves rows between
the shard and the experts' home ranks, so it is left out).  Then the two
engines bitwise equal, the choice of path (``moe_mode``), the router's
custom op under the rank vmap (one call a rank, each with its own
capacity), gradients through the software transport, the distributed
suite's EP check, and arctic served with EP.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import SMOKE as J_SMOKE
from repro.kernels import ref as kref
from repro.models import layers as jlayers
from repro.parallel.ctx import RunCtx as JCtx
from repro_torch.configs.registry import SMOKE
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models.build import build_model, params_from_jax
from repro_torch.parallel.ctx import RunCtx
from repro_torch.testing import dist_suite

ARCH = "arctic-480b"
# f32 on both sides: summation order of the expert products and combine
ATOL = 1e-5
# (data, model) grids and token counts: tokens over data x model, over
# data alone (66 tokens do not divide by 8), and one model rank
CASES = [((2, 4), 128), ((1, 4), 64), ((2, 2), 96), ((2, 4), 66),
         ((1, 1), 32)]


def _cfg(cf=4.0):
    return (dataclasses.replace(J_SMOKE[ARCH], capacity_factor=cf),
            dataclasses.replace(SMOKE[ARCH], capacity_factor=cf))


@pytest.fixture(scope="module")
def moe_params():
    jcfg, _ = _cfg()
    jp, _ = jlayers.moe_init(jcfg, JCtx(mesh=None), jax.random.PRNGKey(1))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _tokens(T, D, seed=3):
    return (np.random.default_rng(seed).normal(size=(T, D)) * 0.1).astype(
        np.float32)


def _reference_ep(jp, jcfg, x2d, grid):
    """The reference's ``_moe_ep`` body, token shard by token shard on
    one JAX device (the shards of ``(data[, model])``, in mesh order)."""
    dp, tp = grid
    T, _ = x2d.shape
    shards = dp * tp if T % (dp * tp) == 0 else dp
    T_l = T // shards
    C_l = max(4, int(math.ceil(T_l * jcfg.top_k * jcfg.capacity_factor
                               / jcfg.n_experts)))
    act = jlayers._act(jcfg.act)
    outs = []
    for i in range(shards):
        x_l = jnp.asarray(x2d[i * T_l:(i + 1) * T_l])
        e, s, w, keep = kref.route_topk(x_l @ jp["router"], k=jcfg.top_k,
                                        capacity=C_l, renormalize=True)
        buf = kref.moe_dispatch(x_l, e, s, keep, n_experts=jcfg.n_experts,
                                capacity=C_l)
        hid = act(jnp.einsum("ecd,edf->ecf", buf, jp["wg"])) * jnp.einsum(
            "ecd,edf->ecf", buf, jp["wi"])
        out_buf = jnp.einsum("ecf,efd->ecd", hid, jp["wo"])
        outs.append(np.asarray(kref.moe_combine(out_buf, e, s, w, keep)))
    return np.concatenate(outs)


def _ep(tp_params, tcfg, x2d, grid, backend="xla"):
    ctx = RunCtx(moe_mode="ep_shardmap", ep_grid=grid, moe_backend=backend)
    return layers._moe_ep(tp_params, tcfg, ctx, torch.from_numpy(x2d))


@pytest.mark.parametrize("grid,T", CASES)
def test_ep_matches_reference_composition_and_engines_agree(
        moe_params, grid, T):
    jp, tparams = moe_params
    jcfg, tcfg = _cfg(cf=1.25)  # the config's own capacity: tokens drop
    x = _tokens(T, tcfg.d_model)
    want = _reference_ep(jp, jcfg, x, grid)
    got = _ep(tparams, tcfg, x, grid, "xla")
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    hw = _ep(tparams, tcfg, x, grid, "gascore")
    assert torch.equal(hw, got)


def test_ep_path_choice_follows_the_reference_rule():
    _, tcfg = _cfg()
    assert not layers.use_ep(tcfg, RunCtx(), 64)  # no model ranks
    assert layers.use_ep(tcfg, RunCtx(ep_grid=(2, 4)), 64)
    assert not layers.use_ep(tcfg, RunCtx(ep_grid=(2, 4)), 63)  # data
    assert not layers.use_ep(tcfg, RunCtx(ep_grid=(1, 3)), 64)  # 8 % 3
    assert not layers.use_ep(tcfg, RunCtx(ep_grid=(2, 4), moe_mode="local"),
                             64)
    assert layers.use_ep(tcfg, RunCtx(moe_mode="ep_shardmap"), 64)
    with pytest.raises(ValueError, match="moe_backend"):
        RunCtx(moe_backend="nccl")
    with pytest.raises(ValueError, match="ep_grid"):
        RunCtx(ep_grid=(0, 4))


def test_apply_moe_ep_with_the_dense_residual_matches_local(moe_params):
    """``apply_moe`` on a (2, 4) grid ("auto") against the local path: at
    capacity factor 4.0 no token drops on either, so they agree."""
    _, tparams = moe_params
    _, tcfg = _cfg()
    x = torch.from_numpy(_tokens(64, tcfg.d_model).reshape(4, 16, -1))
    lo = layers.apply_moe(tparams, tcfg, RunCtx(), x)
    ep = layers.apply_moe(tparams, tcfg, RunCtx(ep_grid=(2, 4)), x)
    assert "dense_res" in tparams
    torch.testing.assert_close(ep, lo, atol=ATOL, rtol=ATOL)


def test_router_op_under_the_rank_vmap_is_one_call_a_rank(monkeypatch):
    """The router's custom op under vmap over 4 ranks calls the kernel's
    wrapper once a rank, on that rank's tokens alone, with the same
    capacity (folding the ranks into T would share every expert's slots:
    the capacity is small enough here that it would drop differently).
    The wrapper needs a card, so here it is the plain router packed as the
    kernel packs it."""
    calls = []

    def plain_packed(logits, *, k, capacity, renormalize):
        calls.append(tuple(logits.shape))
        e, s, w, keep = ref.route_topk(logits, k=k, capacity=capacity,
                                       renormalize=renormalize)
        return torch.stack([e, s, w.view(torch.int32)]), keep

    monkeypatch.setattr(ops._moe, "moe_router", plain_packed)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 24, 8)).astype(np.float32))
    words, keep = torch.func.vmap(
        lambda lg: ops._moe_router_op(lg, 2, 5, True))(x)
    assert calls == [(24, 8)] * 4
    folded = ref.route_topk(x.reshape(96, 8), k=2, capacity=5)
    assert not torch.equal(folded[3].reshape(4, 24, 2), keep)
    for r in range(4):
        e, s, w, k = ref.route_topk(x[r], k=2, capacity=5)
        assert torch.equal(words[r, 0], e) and torch.equal(words[r, 1], s)
        assert torch.equal(words[r, 2].view(torch.float32), w)
        assert torch.equal(keep[r], k)
    got = torch.func.vmap(lambda lg: ops._f32_from_bits(
        ops._moe_router_op(lg, 2, 5, True)[0][2]))(x)
    assert torch.equal(got, words[:, 2].view(torch.float32))


def test_ep_gradients_through_the_software_transport(moe_params):
    """EP on "xla" is differentiable (the all-to-all's VJP is an
    all-to-all): the expert and router gradients of sum(y^2) equal the
    local path's at capacity factor 4.0."""
    _, tparams = moe_params
    _, tcfg = _cfg()
    x = torch.from_numpy(_tokens(64, tcfg.d_model))
    keys = ("router", "wi", "wg", "wo")
    grads = {}
    for name, ctx in (("local", None), ("ep", RunCtx(
            moe_mode="ep_shardmap", ep_grid=(2, 4)))):
        p = {k: tparams[k].clone().requires_grad_() for k in keys}
        if ctx is None:
            y = layers._moe_local(p, tcfg, RunCtx(), x,
                                  layers.moe_capacity(tcfg, 64))
        else:
            y = layers._moe_ep(p, tcfg, ctx, x)
        grads[name] = torch.autograd.grad((y ** 2).sum(), [p[k] for k in keys])
    for a, b in zip(grads["local"], grads["ep"]):
        torch.testing.assert_close(b, a, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("backend", ["xla", "gascore"])
def test_dist_suite_ep_check(backend):
    assert dist_suite.ep_moe_parity(torch.device("cpu"), backend) > 0.97


def test_arctic_served_with_ep_on_both_engines():
    """arctic-480b (SMOKE) through ``PagedServer`` with EP on a (1, 4)
    grid: "gascore" tokens equal "xla"'s, every token in the vocabulary,
    each decode batch's tokens over the model ranks when they divide."""
    cfg = SMOKE[ARCH]
    model = build_model(cfg)
    params = model.init(RunCtx(), torch.Generator().manual_seed(0),
                        device="cpu")
    outs = {}
    for backend in ("xla", "gascore"):
        ctx = RunCtx(ep_grid=(1, 4), moe_backend=backend)
        server = serve.PagedServer(model, ctx, params, 4, 48, device="cpu",
                                   page_tokens=8)
        rng = np.random.default_rng(7)
        for rid in range(4):
            server.submit(serve.Request(
                rid=rid, prompt=rng.integers(0, cfg.vocab, size=8).tolist(),
                max_new=4))
        server.run_until_drained()
        outs[backend] = {r.rid: r.out for r in server.finished}
    assert outs["gascore"] == outs["xla"] and len(outs["xla"]) == 4
    assert all(0 <= t < cfg.vocab for o in outs["xla"].values() for t in o)
