"""Mamba-1 selective scan on the GPU: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro.kernels.ssm_scan.selective_scan``
(``_ssm_kernel``): the recurrence ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t)
B_t``, ``y_t = C_t . h_t + D x_t`` over ``(B, S, Di)`` with ``N`` states
per channel, the state kept on chip.  The kernel is ``csrc/ssm_scan.cu``
(its header gives the bound and the design); it can also write the final
state ``h_S (B, Di, N)`` f32 that a prefill hands to decode.  This module
checks the inputs, launches it on PyTorch's current stream and counts the
launches.

The wrapper takes CUDA tensors only.  CPU tensors go to the plain versions
``repro_torch.kernels.ref.selective_scan`` / ``mamba_final_state``
through ``repro_torch.kernels.ops``.  There is no backward kernel (the
reference has none either): a call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import build

__all__ = ["selective_scan", "NAME"]

NAME = "ssm_scan"
STATES = (4, 8, 16, 32)  # N the kernel takes: 4 states per lane, 1-8 lanes
MAX_BATCH = 65535  # batch rows are the grid's y dimension
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        f = build.load(NAME).repro_ssm_scan
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, ll, ll, ll, ll, p]
        f.restype = ctypes.c_int
        _fn = f
    return _fn


def selective_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
    *,
    final_state: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Launch the CUDA kernel; returns y ``(B, S, Di)`` in x's dtype, and
    with ``final_state`` also ``h_S (B, Di, N)`` f32.

    x and dt are contiguous ``(B, S, Di)``, x f32 or bf16, dt f32; a
    ``(Di, N)`` and d ``(Di,)`` contiguous f32; b and c ``(B, S, N)`` in
    x's dtype, read through their batch and time strides (views sliced
    out of one projection are taken as they are), N contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
    named = (("dt", dt), ("a", a), ("b", b), ("c", c), ("d", d))
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (x,) + tuple(t for _, t in named)
    ):
        raise RuntimeError(
            "selective_scan has no backward kernel: call it under "
            "torch.no_grad(), or on the CPU for a differentiable scan"
        )
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}: float32 or bfloat16")
    if b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("x, b and c must share one dtype")
    if any(t.dtype != torch.float32 for t in (dt, a, d)):
        raise TypeError("dt, a and d must be float32")
    B, S, Di = x.shape
    N = a.shape[-1]
    if (dt.shape != x.shape or a.shape != (Di, N) or d.shape != (Di,)
            or b.shape != (B, S, N) or c.shape != (B, S, N)):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, d "
            f"{tuple(d.shape)} do not match"
        )
    if N not in STATES:
        raise ValueError(f"state size N={N}: the kernel takes {STATES}")
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} > {MAX_BATCH} rows")
    if not all(t.is_contiguous() for t in (x, dt, a, d)):
        raise ValueError("x, dt, a and d must be contiguous")
    if b.stride(2) != 1 or c.stride(2) != 1:
        raise ValueError("b and c need their state axis contiguous")
    y = torch.empty_like(x)
    h: Optional[torch.Tensor] = None
    if final_state:
        h = torch.empty((B, Di, N), dtype=torch.float32, device=x.device)
    if B * Di == 0 or S == 0:
        if h is not None:
            h.zero_()
        return (y, h) if final_state else y
    err = _kernel()(
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        b.data_ptr(), c.data_ptr(), d.data_ptr(), y.data_ptr(),
        None if h is None else h.data_ptr(), B, S, Di, N,
        b.stride(0), b.stride(1), c.stride(0), c.stride(1),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"selective_scan launch failed: CUDA error {err}")
    selective_scan.launches += 1
    return (y, h) if final_state else y


selective_scan.launches = 0
