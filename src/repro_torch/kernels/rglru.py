"""RG-LRU gated linear scan on the GPU: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro.kernels.rglru.gated_linear_scan``
(``_lru_kernel``): ``h_t = a_t h_{t-1} + b_t`` over axis 1 of
``(B, S, W)``, the state kept on chip, every ``h_t`` returned in b's
dtype.  The kernel is ``csrc/rglru.cu`` (its header gives the bound and
the design); this module checks the inputs, launches it on PyTorch's
current stream and counts the launches.

The wrapper takes CUDA tensors only.  CPU tensors go to the plain version
``repro_torch.kernels.ref.gated_linear_scan`` through
``repro_torch.kernels.ops``.  There is no backward kernel (the reference
has none either): a call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["gated_linear_scan", "NAME"]

NAME = "rglru"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BATCH = 65535  # batch rows are the grid's y dimension

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = build.load(NAME).repro_rglru_scan
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [i, p, p, p, i, i, i, p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def gated_linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; returns ``(B, S, W)`` in b's dtype.  a and
    b are contiguous ``(B, S, W)`` of one dtype, f32 or bf16."""
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {a.device}")
    if b.device != a.device:
        raise ValueError(f"b on {b.device}, a on {a.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError(
            "gated_linear_scan has no backward kernel: call it under "
            "torch.no_grad(), or on the CPU for a differentiable scan"
        )
    if b.dtype not in _DTYPES or a.dtype != b.dtype:
        raise TypeError(
            f"a {a.dtype}, b {b.dtype}: one dtype, float32 or bfloat16"
        )
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(
            f"a {tuple(a.shape)} and b {tuple(b.shape)}: one (B, S, W) shape"
        )
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    B, S, W = b.shape
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} > {MAX_BATCH} rows")
    y = torch.empty_like(b)
    if y.numel() == 0:
        return y
    err = _kernel()(
        _DTYPES[b.dtype], a.data_ptr(), b.data_ptr(), y.data_ptr(), B, S, W,
        torch.cuda.current_stream(b.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"gated_linear_scan launch failed: CUDA error {err}")
    gated_linear_scan.launches += 1
    return y


gated_linear_scan.launches = 0
