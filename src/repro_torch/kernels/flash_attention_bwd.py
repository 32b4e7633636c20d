"""Flash-attention backward on the GPU, and the differentiable attention.

Replaces the TPU kernels ``_dkv_kernel`` and ``_dq_kernel`` of
``repro.kernels.flash_attention_bwd`` and their custom VJP
``flash_attention_vjp``:

- :func:`flash_attention_dkv` launches ``csrc/flash_attention_bwd.cu``'s
  dK/dV kernel: one CTA per (KV block, KV head, batch), looping over the
  GQA group's q heads x q blocks; dK and dV in k's and v's dtype.
- :func:`flash_attention_dq` launches its dQ kernel: one CTA per (q block,
  q head, batch), looping over the KV blocks; dQ in q's dtype.
- :class:`FlashAttention` is the ``torch.autograd.Function`` counterpart of
  ``flash_attention_vjp``.  Its forward runs the forward kernel with the
  row log-sum-exp and saves ``q, k, v, out, lse``; its backward computes
  ``delta = rowsum(dO * O)`` in plain torch and launches the two kernels.
  On CPU tensors it runs the same steps on the plain versions of
  ``repro_torch.kernels.ref``; on any other device it raises.

The wrappers take contiguous CUDA tensors only, check them, launch on
PyTorch's current stream and count their launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_attention as _fa

__all__ = ["NAME", "FlashAttention", "flash_attention_dkv",
           "flash_attention_dq"]

NAME = "flash_attention_bwd"  # csrc/flash_attention_bwd.cu

_fns: dict = {}


def _kernel(symbol: str, n_out: int):
    f = _fns.get(symbol)
    if f is None:
        f = getattr(build.load(NAME), symbol)
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = ([i] + [p] * (6 + n_out) + [i] * 6
                      + [ctypes.c_float, i, i, p])
        f.restype = ctypes.c_int
        _fns[symbol] = f
    return f


def _check_bwd(q, k, v, dout, lse, delta, window, block_q, block_k):
    B, Hq, Hkv, Sq, Sk, D = _fa.check_qkv(q, k, v, window)
    _fa.check_blocks(Sq, Sk, block_q, block_k)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("dout must have q's shape and dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, Hq, Sq) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be ({B}, {Hq}, {Sq}) float32")
    _fa.check_inputs(q, k, v, dout, lse, delta, names="q k v dout lse delta")
    return B, Hq, Hkv, Sq, Sk, D


def _launch(symbol, q, ptrs, dims, scale, causal, window):
    B, Hq, Hkv, Sq, Sk, D = dims
    if scale is None:
        scale = 1.0 / (D**0.5)
    err = _kernel(symbol, len(ptrs) - 6)(
        _fa.DTYPES[q.dtype], *ptrs, B, Hq, Hkv, Sq, Sk, D, float(scale),
        int(causal), -1 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


def flash_attention_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool = True,
    window: Optional[int] = None, scale: Optional[float] = None,
    block_q: int = 128, block_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel; returns ``(dk, dv)`` shaped like k and v."""
    dims = _check_bwd(q, k, v, dout, lse, delta, window, block_q, block_k)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta, dk, dv)]
    _launch("repro_flash_attention_dkv", q, ptrs, dims, scale, causal, window)
    flash_attention_dkv.launches += 1
    return dk, dv


def flash_attention_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, *, causal: bool = True,
    window: Optional[int] = None, scale: Optional[float] = None,
    block_q: int = 128, block_k: int = 128,
) -> torch.Tensor:
    """Launch the dQ kernel; returns dq shaped like q."""
    dims = _check_bwd(q, k, v, dout, lse, delta, window, block_q, block_k)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta, dq)]
    _launch("repro_flash_attention_dq", q, ptrs, dims, scale, causal, window)
    flash_attention_dq.launches += 1
    return dq


flash_attention_dkv.launches = 0
flash_attention_dq.launches = 0


class FlashAttention(torch.autograd.Function):
    """``out = attention(q, k, v)`` with the flash backward.

    ``apply(q, k, v, causal, window, scale, block_q, block_k)``: the last
    five are plain arguments with no gradient (``flash_attention_vjp``'s
    ``nondiff_argnums``).  q ``(B, Hq, Sq, D)``, k and v ``(B, Hkv, Sk, D)``,
    contiguous."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, block_q, block_k):
        _fa.check_blocks(q.shape[2], k.shape[2], block_q, block_k)
        kw = dict(causal=causal, window=window, scale=scale)
        if q.device.type == "cuda":
            out, lse = _fa.flash_attention_fwd(
                q, k, v, block_q=block_q, block_k=block_k, **kw)
        elif q.device.type == "cpu":
            out, lse = ref.flash_attention_fwd(q, k, v, **kw)
        else:
            raise ValueError(f"no flash attention for device {q.device}")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        ctx.blocks = dict(block_q=block_q, block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            dout = dout.contiguous()
            delta = (dout.float() * out.float()).sum(-1)
            dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta,
                                         **ctx.kw, **ctx.blocks)
            dq = flash_attention_dq(q, k, v, dout, lse, delta,
                                    **ctx.kw, **ctx.blocks)
        else:
            dq, dk, dv = ref.flash_attention_bwd(q, k, v, out, lse, dout,
                                                 **ctx.kw)
        return dq, dk, dv, None, None, None, None, None
