"""Flash-attention forward on the GPU: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro.kernels.flash_attention.flash_attention``
(``_fa_kernel``) with ``return_lse=True``: q ``(B, Hq, Sq, D)`` against k, v
``(B, Hkv, Sk, D)`` with GQA, a causal mask and/or a sliding window (q and
k positions both counted from 0), returning the output in q's dtype and
the row log-sum-exp ``(B, Hq, Sq)`` in f32.  The kernel is
``csrc/flash_attention.cu`` (its header gives the bound and the design);
this module checks the inputs, launches it on PyTorch's current stream and
counts the launches.  The checks are shared with the backward kernels'
wrappers in ``flash_attention_bwd``.

The wrapper takes contiguous CUDA tensors only.  CPU tensors go to the
plain version ``repro_torch.kernels.ref.flash_attention_fwd`` through
``repro_torch.kernels.ops.attention``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["NAME", "HEAD_DIMS", "check_blocks", "check_inputs", "check_qkv",
           "flash_attention_fwd"]

NAME = "flash_attention"  # csrc/flash_attention.cu
HEAD_DIMS = (16, 32, 64, 128, 256)  # the head dims the kernels are built for
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = build.load(NAME).repro_flash_attention_fwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [i, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i,
                      p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def check_blocks(Sq: int, Sk: int, block_q: int, block_k: int) -> None:
    """The reference's tiling contract (``flash_attention.py:149-154``):
    each sequence is a whole number of its (clipped) blocks.  The CUDA
    kernels tile by their own blocks (64 or 128 rows) and mask a ragged
    edge; the check keeps the reference's contract on every device."""
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"seq ({Sq},{Sk}) not divisible by blocks ({bq},{bk})")


def check_inputs(*tensors: torch.Tensor, names: str) -> None:
    """Every tensor on one CUDA device, contiguous, 16-byte aligned."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    for name, t in zip(names.split(), tensors):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int]) -> Tuple[int, int, int, int, int, int]:
    """Shapes, dtypes and the window of a kernel call; returns
    ``(B, Hq, Hkv, Sq, Sk, D)``."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B, H, S, D)")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if Bk != B or Dk != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ")
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernels take {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise TypeError(f"unsupported dtype {q.dtype}: float32 or bfloat16")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if window is not None and window < 0:
        raise ValueError(f"window {window} < 0")
    return B, Hq, Hkv, Sq, Sk, D


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; returns ``(out, lse)``: ``(B, Hq, Sq, D)`` in
    q's dtype and ``(B, Hq, Sq)`` f32."""
    B, Hq, Hkv, Sq, Sk, D = check_qkv(q, k, v, window)
    check_blocks(Sq, Sk, block_q, block_k)
    check_inputs(q, k, v, names="q k v")
    if scale is None:
        scale = 1.0 / (D**0.5)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    err = _kernel()(
        DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), B, Hq, Hkv, Sq, Sk, D, float(scale),
        int(causal), -1 if window is None else int(window),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
