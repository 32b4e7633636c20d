"""RG-LRU gated linear scan on the GPU: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro.kernels.rglru.gated_linear_scan``
(``_lru_kernel``): ``h_t = a_t h_{t-1} + b_t`` over axis 1 of
``(B, S, W)``, the state kept on chip, every ``h_t`` returned in b's
dtype.  The kernel is ``csrc/rglru.cu`` (its header gives the bound and
the design); this module checks the inputs, launches it on PyTorch's
current stream and counts the launches.

The backward is a hand kernel too, ``csrc/rglru_bwd.cu`` (the reference
has no Pallas backward: XLA differentiates its ``lax.scan`` oracle; the
port's forward is a kernel, so its gradient is one):
:func:`gated_linear_scan_bwd` launches it, and :class:`GatedLinearScan`
binds the two into the differentiable scan that ``ops.gated_linear_scan``
takes whenever an input needs a gradient.

The wrappers take CUDA tensors only.  CPU tensors go to the plain versions
``repro_torch.kernels.ref.gated_linear_scan`` / ``gated_linear_scan_bwd``
through ``repro_torch.kernels.ops`` and :class:`GatedLinearScan`.
:func:`gated_linear_scan` itself refuses a call that would need a
gradient: the differentiable scan is :class:`GatedLinearScan`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build, cost, ref

__all__ = ["gated_linear_scan", "gated_linear_scan_bwd", "GatedLinearScan",
           "NAME", "NAME_BWD"]

NAME = "rglru"
NAME_BWD = "rglru_bwd"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BATCH = 65535  # batch rows are the grid's y dimension

_fn = None
_bwd = None


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
            "gated_linear_scan is the forward alone: the differentiable "
            "scan is GatedLinearScan (ops.gated_linear_scan takes it)"
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


def _bwd_kernel():
    global _bwd
    if _bwd is None:
        f = build.load(NAME_BWD).repro_rglru_scan_bwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [i, p, p, p, p, p, i, i, i, p]
        f.restype = ctypes.c_int
        _bwd = f
    return _bwd


def gated_linear_scan_bwd(
    a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel; returns ``(da, db)``.  a, the forward's
    output h and its cotangent dh are contiguous ``(B, S, W)`` of one
    dtype, f32 or bf16."""
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {a.device}")
    if h.device != a.device or dh.device != a.device:
        raise ValueError(f"h on {h.device}, dh on {dh.device}, a on {a.device}")
    if a.dtype not in _DTYPES or h.dtype != a.dtype or dh.dtype != a.dtype:
        raise TypeError(
            f"a {a.dtype}, h {h.dtype}, dh {dh.dtype}: one dtype, float32 "
            "or bfloat16"
        )
    if a.dim() != 3 or h.shape != a.shape or dh.shape != a.shape:
        raise ValueError(
            f"a {tuple(a.shape)}, h {tuple(h.shape)}, dh {tuple(dh.shape)}: "
            "one (B, S, W) shape"
        )
    if not (a.is_contiguous() and h.is_contiguous() and dh.is_contiguous()):
        raise ValueError("a, h and dh must be contiguous")
    B, S, W = a.shape
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} > {MAX_BATCH} rows")
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    err = _bwd_kernel()(
        _DTYPES[a.dtype], a.data_ptr(), h.data_ptr(), dh.data_ptr(),
        da.data_ptr(), db.data_ptr(), B, S, W,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"gated_linear_scan_bwd launch failed: CUDA error {err}")
    gated_linear_scan_bwd.launches += 1
    return da, db


gated_linear_scan_bwd.launches = 0


class GatedLinearScan(torch.autograd.Function):
    """``h = gated_linear_scan(a, b)`` with the backward kernel.

    ``apply(a, b)``: the forward runs the forward kernel and saves a and
    its output h; the backward launches :func:`gated_linear_scan_bwd`.
    On CPU tensors the same steps run on the plain versions, on ``meta``
    as shape-only stand-ins (the dry run), on any other device it raises.
    Each kernel call is reported to an active op-stream counter as one op
    (``kernels.cost``)."""

    @staticmethod
    def forward(ctx, a, b):
        with _report("gated_linear_scan", b):
            if b.device.type == "cuda":
                h = gated_linear_scan(a, b)
            elif b.device.type == "cpu":
                h = ref.gated_linear_scan(a, b)
            elif b.device.type == "meta":
                h = torch.empty_like(b)
            else:
                raise ValueError(
                    f"no gated_linear_scan for device {b.device}")
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        dh = dh.to(h.dtype).contiguous()
        with _report("gated_linear_scan_bwd", h):
            if h.device.type == "cuda":
                return gated_linear_scan_bwd(a, h, dh)
            if h.device.type == "cpu":
                return ref.gated_linear_scan_bwd(a, h, dh)
            return torch.empty_like(a), torch.empty_like(h)


def _report(name, b):
    nbytes, flops = cost.scan_work(name, tuple(b.shape), b.dtype)
    return cost.kernel(name, flops, nbytes)
