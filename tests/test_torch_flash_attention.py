"""The port's flash attention against the JAX reference, on the CPU.

The same numpy inputs (from a seed) go through both packages.  The
port's plain ``attention`` and ``flash_attention_fwd`` are held against
``repro.kernels.ref.attention`` and the Pallas ``flash_attention`` in
interpret mode (out and lse); ``ops.attention``'s gradients, which on the
CPU run ``FlashAttention`` over the plain backward, against ``jax.grad``
of ``flash_attention_vjp`` in interpret mode and of ``ref.attention``.
Tolerances are the reference's own (``tests/test_kernels.py``): 2e-5 in
f32 and 2e-2 in bf16 for the forward, 5e-4 for the gradients.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention_bwd import flash_attention_vjp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops, ref

# (B, Hq, Hkv, S, D, causal, window, dtype): tests/test_kernels.py:21-28
FA_CASES = [
    (2, 4, 2, 256, 64, True, None, "float32"),
    (1, 4, 4, 128, 128, True, None, "float32"),
    (2, 8, 2, 256, 64, True, 64, "float32"),
    (1, 2, 1, 128, 64, False, None, "float32"),
    (1, 4, 1, 256, 128, True, None, "bfloat16"),
    (1, 2, 2, 128, 64, True, 32, "bfloat16"),
    # head dim 256 (recurrentgemma-9b's local layers): MQA at a group of 4,
    # a window shorter than S, causal and not
    (1, 4, 1, 256, 256, True, 64, "float32"),
    (1, 4, 1, 128, 256, False, None, "float32"),
    (1, 4, 1, 256, 256, True, None, "bfloat16"),
    (1, 4, 1, 128, 256, False, 48, "bfloat16"),
]
# (B, Hq, Hkv, S, D, causal, window): tests/test_kernels.py:331-336, then
# head dim 256 as above, f32 and bf16 (an eighth entry: the dtype)
FA_BWD_CASES = [
    (1, 2, 1, 128, 64, True, None),
    (2, 4, 2, 128, 64, True, None),
    (1, 2, 2, 128, 64, False, None),
    (1, 4, 1, 128, 64, True, 64),
    (1, 4, 1, 128, 256, True, 48),
    (1, 4, 1, 128, 256, False, None),
    (1, 4, 1, 128, 256, True, 48, "bfloat16"),
    (1, 4, 1, 128, 256, False, 48, "bfloat16"),
]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 5e-4


def _qkv(B, Hq, Hkv, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Sk, D)).astype(np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("case", FA_CASES, ids=[str(c) for c in FA_CASES])
def test_forward_and_lse_match_reference(case):
    B, Hq, Hkv, S, D, causal, window, dtype = case
    arrays = _qkv(B, Hq, Hkv, S, S, D, seed=S + D + Hq)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in arrays)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in arrays)
    kw = dict(causal=causal, window=window)
    want = jref.attention(jq, jk, jv, **kw)
    j_out, j_lse = j_flash(jq, jk, jv, interpret=True, return_lse=True, **kw)
    plain = ref.attention(tq, tk, tv, **kw)
    out, lse = ref.flash_attention_fwd(tq, tk, tv, **kw)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, Hq, S)
    tol = TOL[dtype]
    for got in (plain, out):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
        np.testing.assert_allclose(_np(got), _np(j_out), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(lse), _np(j_lse), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", FA_BWD_CASES,
                         ids=[str(c) for c in FA_BWD_CASES])
def test_gradients_match_reference(case):
    """f32: the gradients of sum(out^2).  bf16: the port on bf16 inputs
    and a bf16 cotangent against the reference in f32 on the same rounded
    values, within the bf16 forward's 2e-2 (the port rounds out, which
    delta reads, and dq, dk, dv to 8 mantissa bits)."""
    B, Hq, Hkv, S, D, causal, window, *dtype = case
    arrays = _qkv(B, Hq, Hkv, S, S, D, seed=7 * S + Hq)
    if dtype:
        dout = np.random.default_rng(S + D).normal(size=(B, Hq, S, D))
        tq, tk, tv, tdo = (torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16) for x in (*arrays, dout))
        leaves = [t.requires_grad_() for t in (tq, tk, tv)]
        out = ops.attention(*leaves, causal=causal, window=window,
                            block_q=64, block_k=64)
        got = torch.autograd.grad(out, leaves, tdo)
        jqkv = tuple(jnp.asarray(t.detach().float().numpy())
                     for t in (tq, tk, tv))
        jdo = jnp.asarray(tdo.float().numpy())
        _, vjp = jax.vjp(lambda q, k, v: flash_attention_vjp(
            q, k, v, causal, window, None, 64, 64, True), *jqkv)
        for a, b in zip(got, vjp(jdo)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(a), _np(b), atol=TOL["bfloat16"],
                                       rtol=TOL["bfloat16"])
        return
    jqkv = tuple(jnp.asarray(x) for x in arrays)

    def loss_vjp(q, k, v):
        return (flash_attention_vjp(q, k, v, causal, window, None, 64, 64,
                                    True) ** 2).sum()

    def loss_ref(q, k, v):
        return (jref.attention(q, k, v, causal=causal, window=window) ** 2).sum()

    g_vjp = jax.grad(loss_vjp, argnums=(0, 1, 2))(*jqkv)
    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2))(*jqkv)
    tqkv = [torch.from_numpy(x).requires_grad_() for x in arrays]
    out = ops.attention(*tqkv, causal=causal, window=window, block_q=64,
                        block_k=64)
    got = torch.autograd.grad((out**2).sum(), tqkv)
    for a, b, c in zip(got, g_vjp, g_ref):
        np.testing.assert_allclose(_np(a), _np(b), atol=GRAD_TOL, rtol=GRAD_TOL)
        np.testing.assert_allclose(_np(a), _np(c), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_fully_masked_rows():
    """Non-causal window 32 with Sq 256 over Sk 128: query rows from 159 on
    see no key.  Out 0 and lse -1e30 there, as in JAX, and no gradient
    flows through them."""
    B, Hq, Hkv, Sq, Sk, D, window = 1, 2, 1, 256, 128, 64, 32
    arrays = _qkv(B, Hq, Hkv, Sq, Sk, D, seed=11)
    kw = dict(causal=False, window=window)
    j_out, j_lse = j_flash(*(jnp.asarray(x) for x in arrays), interpret=True,
                           return_lse=True, **kw)
    tqkv = [torch.from_numpy(x).requires_grad_() for x in arrays]
    out, lse = ref.flash_attention_fwd(*(t.detach() for t in tqkv), **kw)
    hidden = ~ref.attention_mask(Sq, Sk, False, window, "cpu").any(-1)
    first = int(hidden.nonzero()[0])
    assert first == 159 and bool(hidden[first:].all())
    assert float(out[:, :, first:].abs().max()) == 0.0
    assert bool((lse[:, :, first:] == -1e30).all())
    np.testing.assert_array_equal(np.asarray(j_lse)[:, :, first:],
                                  np.float32(-1e30))
    np.testing.assert_allclose(_np(out), _np(j_out), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(lse), _np(j_lse), atol=2e-5, rtol=2e-5)
    y = ops.attention(*tqkv, **kw)
    dq, dk, dv = torch.autograd.grad((y**2).sum() + y[:, :, first:].sum(),
                                     tqkv)
    assert float(dq[:, :, first:].abs().max()) == 0.0
    assert all(torch.isfinite(g).all() for g in (dq, dk, dv))


def test_plain_backward_matches_autograd_of_plain_attention():
    """ref.flash_attention_bwd (delta, dK/dV, dQ as the kernels split them)
    against torch autograd through ref.attention, GQA and a window."""
    arrays = _qkv(2, 4, 2, 64, 64, 64, seed=3)
    tqkv = [torch.from_numpy(x).requires_grad_() for x in arrays]
    kw = dict(causal=True, window=48)
    dout = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 4, 64, 64)).astype(np.float32))
    want = torch.autograd.grad(ref.attention(*tqkv, **kw), tqkv, dout)
    q, k, v = (t.detach() for t in tqkv)
    out, lse = ref.flash_attention_fwd(q, k, v, **kw)
    got = ref.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (False, 24)])
def test_f64_dkv_sums_match_the_plain_version(causal, window):
    """ref.flash_attention_dkv_f64 (the exact sums the card's long-group
    dK/dV checks hold both sides to) computes what the f32 plain version
    does, left in f64: a group of 4, causal or a two-sided window."""
    arrays = _qkv(2, 8, 2, 64, 64, 32, seed=5)
    q, k, v = (torch.from_numpy(x) for x in arrays)
    dout = torch.from_numpy(np.random.default_rng(6).normal(
        size=(2, 8, 64, 32)).astype(np.float32))
    kw = dict(causal=causal, window=window)
    out, lse = ref.flash_attention_fwd(q, k, v, **kw)
    delta = (dout * out).sum(-1)
    got = ref.flash_attention_dkv_f64(q, k, v, dout, lse, delta, **kw)
    want = ref.flash_attention_dkv(q, k, v, dout, lse, delta, **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b.double(), atol=1e-5, rtol=1e-5)


# (B, Hq, Hkv, (Sq, Sk), D, causal, window): a GQA group of 2 and Sk 96,
# which leaves a ragged last tile of the bf16 dQ kernel's 64 kv rows
DQ_BF16_CASES = [
    (1, 4, 2, (128, 96), 32, True, None),
    (1, 4, 2, (128, 96), 32, True, 40),
]


def _dq_as_bf16_kernel_rounds(q, k, v, dout, lse, delta, causal, window,
                              scale):
    """dQ with the bf16 tensor-core kernel's rounding points: S = q . k^T
    and dP = dO . v^T in f32 from the bf16 inputs, p = exp(S * scale -
    lse) under the mask, dS = p * (dP - delta) in f32, dS rounded to bf16
    as the input of dS . K, that product summed in f32, scale applied at
    the store, dQ rounded to bf16."""
    group = q.shape[1] // k.shape[1]
    kx = k.float().repeat_interleave(group, 1)
    vx = v.float().repeat_interleave(group, 1)
    mask = ref.attention_mask(q.shape[2], k.shape[2], causal, window, "cpu")
    s = q.float() @ kx.transpose(-1, -2)
    p = torch.where(mask, torch.exp(s * scale - lse[..., None]), 0.0)
    ds = p * (dout.float() @ vx.transpose(-1, -2) - delta[..., None])
    dq = ds.to(torch.bfloat16).float() @ kx
    return (dq * scale).to(torch.bfloat16)


@pytest.mark.parametrize("case", DQ_BF16_CASES,
                         ids=[str(c) for c in DQ_BF16_CASES])
def test_dq_bf16_rounding_points_match_reference(case):
    """The bf16 dQ kernel's rounding points, emulated in plain torch on
    bf16 inputs (out and lse from the plain forward, delta = rowsum(dO *
    out) in f32 as ``FlashAttention.backward`` computes it), against the q
    gradient of the JAX ``flash_attention_vjp`` in interpret mode (its
    ``_dq_kernel``, all f32) on the same bf16-rounded values, within the
    bf16 bound 2e-2 x (1 + |reference|) that the card holds the kernel
    to."""
    B, Hq, Hkv, (Sq, Sk), D, causal, window = case
    arrays = _qkv(B, Hq, Hkv, Sq, Sk, D, seed=Sq + Sk + (window or 0))
    dout = np.random.default_rng(5).normal(size=(B, Hq, Sq, D))
    tq, tk, tv, tdo = (torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16) for x in (*arrays, dout))
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (tq, tk, tv,
                                                                 tdo))
    _, vjp = jax.vjp(lambda q: flash_attention_vjp(
        q, jk, jv, causal, window, None, 64, 32, True), jq)
    want = vjp(jdo)[0]
    scale = 1.0 / D**0.5
    kw = dict(causal=causal, window=window)
    out, lse = ref.flash_attention_fwd(tq, tk, tv, **kw)
    delta = (tdo.float() * out.float()).sum(-1)
    got = _dq_as_bf16_kernel_rounds(tq, tk, tv, tdo, lse, delta, causal,
                                    window, scale)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Hq, Sq, D)
    diff = np.abs(_np(got) - _np(want))
    assert (diff <= 2e-2 * (1 + np.abs(_np(want)))).all(), diff.max()


def test_dispatch_and_checks():
    """Blocks that do not divide the sequence raise on every device; the
    CUDA wrappers refuse CPU tensors before any build or launch; on
    ``meta`` (the dry run) the forward is a shape-only stand-in that
    launches nothing."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 1, 96, 96, 64, 0))
    with pytest.raises(ValueError, match="divisible"):
        ops.attention(q, k, v, block_q=64, block_k=64)
    before = (fa.flash_attention_fwd.launches, fab.flash_attention_dkv.launches,
              fab.flash_attention_dq.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, k, v)
    lse = torch.zeros((1, 2, 96))
    with pytest.raises(ValueError, match="CUDA"):
        fab.flash_attention_dkv(q, k, v, q, lse, lse)
    with pytest.raises(ValueError, match="head dim"):
        fab.flash_attention_dq(q[..., :48].contiguous(), k[..., :48].contiguous(),
                               v[..., :48].contiguous(), q[..., :48], lse, lse)
    assert before == (fa.flash_attention_fwd.launches,
                      fab.flash_attention_dkv.launches,
                      fab.flash_attention_dq.launches)
    meta = torch.empty((1, 2, 64, 64), device="meta")
    out = ops.attention(meta, meta[:, :1], meta[:, :1])
    assert out.device.type == "meta" and out.shape == meta.shape
    assert before == (fa.flash_attention_fwd.launches,
                      fab.flash_attention_dkv.launches,
                      fab.flash_attention_dq.launches)


@pytest.mark.parametrize("D", [192, 256, 512])
def test_head_dim_dispatch(D):
    """Head dim 256 passes the wrappers' checks (on CPU tensors they then
    refuse the device, before any build or launch); 192 and 512 are
    refused for their head dim."""
    assert fa.HEAD_DIMS == (16, 32, 64, 128, 256)
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 1, 64, 64, D, 0))
    lse = torch.zeros((1, 4, 64))
    calls = (lambda: fa.flash_attention_fwd(q, k, v),
             lambda: fab.flash_attention_dkv(q, k, v, q, lse, lse),
             lambda: fab.flash_attention_dq(q, k, v, q, lse, lse))
    for call in calls:
        with pytest.raises(ValueError, match="CUDA" if D == 256
                           else "head dim"):
            call()


def test_training_shape_bounds():
    """chip_smoke.py's least times at the training shape (B 2, 32 q / 8 KV
    heads, S 2048, D 128, causal, bf16): 2, 4 and 3 products of 2 * D flops
    over the S (S + 1) / 2 visible pairs at 989 TFLOP/s, all bound by
    operations (84 MB in and out of the forward take 25 us at 3.35 TB/s)."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    b = chip_smoke.flash_bounds(chip_smoke.TRAIN_SHAPE + (torch.bfloat16,))
    pairs_flops = 2 * 32 * 2 * 128 * (2048 * 2049 // 2)  # B Hq 2D pairs
    for name, products, us in (("flash_attention_fwd", 2, 69.5),
                               ("flash_attention_dkv", 4, 139.1),
                               ("flash_attention_dq", 3, 104.3)):
        assert b[name]["flops"] == products * pairs_flops
        assert b[name]["bound_by"] == "operations"
        assert abs(1e3 * b[name]["bound_ms"] - us) < 0.1
    assert abs(b["flash_attention_fwd"]["bytes"] / 1e6 - 84.4) < 0.1
