"""Mamba-1 selective scan on the GPU: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro.kernels.ssm_scan.selective_scan``
(``_ssm_kernel``): the recurrence ``h_t = exp(dt_t A) h_{t-1} + (dt_t x_t)
B_t``, ``y_t = C_t . h_t + D x_t`` over ``(B, S, Di)`` with ``N`` states
per channel, the state kept on chip.  The kernel is ``csrc/ssm_scan.cu``
(its header gives the bound and the design); it can also write the final
state ``h_S (B, Di, N)`` f32 that a prefill hands to decode.  This module
checks the inputs, launches it on PyTorch's current stream and counts the
launches.

The backward is a hand kernel too, ``csrc/ssm_scan_bwd.cu`` (the
reference has no Pallas backward: XLA differentiates its ``lax.scan``
oracle; the port's forward is a kernel, so its gradient is one):
:func:`selective_scan_bwd` launches it, and :class:`SelectiveScan` binds
the two into the differentiable scan that ``ops.selective_scan`` takes
whenever an input needs a gradient.

The wrappers take CUDA tensors only.  CPU tensors go to the plain versions
``repro_torch.kernels.ref.selective_scan`` / ``mamba_final_state`` /
``selective_scan_bwd`` through ``repro_torch.kernels.ops`` and
:class:`SelectiveScan`.  :func:`selective_scan` itself refuses a call
that would need a gradient: the differentiable scan is
:class:`SelectiveScan`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import build, cost, ref

__all__ = ["selective_scan", "selective_scan_bwd", "SelectiveScan", "NAME",
           "NAME_BWD"]

NAME = "ssm_scan"
NAME_BWD = "ssm_scan_bwd"
STATES = (4, 8, 16, 32)  # N the kernel takes: 4 states per lane, 1-8 lanes
MAX_BATCH = 65535  # batch rows are the grid's y dimension
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None
_bwd = None


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
            "selective_scan is the forward alone: the differentiable scan "
            "is SelectiveScan (ops.selective_scan takes it)"
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


def _bwd_kernel():
    global _bwd
    if _bwd is None:
        lib = build.load(NAME_BWD)
        f = lib.repro_ssm_scan_bwd
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        f.argtypes = [i] + [p] * 14 + [i] * 4 + [ll] * 4 + [p]
        f.restype = ctypes.c_int
        ws = lib.repro_ssm_scan_bwd_workspace
        ws.argtypes = [i] * 4
        ws.restype = ll
        _bwd = f, ws
    return _bwd


def selective_scan_bwd(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
    dy: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernel; returns ``(dx, ddt, dA, dB, dC, dD)``
    for the cotangent dy of y: dx, dB and dC in x's dtype (dB and dC
    contiguous), ddt, dA and dD f32.  The inputs as :func:`selective_scan`
    takes them, dy contiguous ``(B, S, Di)`` in x's dtype.  One call
    launches the scan kernel and its three small reductions (dB and dC
    over channel blocks, dA and dD over batch rows) and counts once."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
    for name, t in (("dt", dt), ("a", a), ("b", b), ("c", c), ("d", d),
                    ("dy", dy)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {x.dtype}: float32 or bfloat16")
    if b.dtype != x.dtype or c.dtype != x.dtype or dy.dtype != x.dtype:
        raise TypeError("x, b, c and dy must share one dtype")
    if any(t.dtype != torch.float32 for t in (dt, a, d)):
        raise TypeError("dt, a and d must be float32")
    B, S, Di = x.shape
    N = a.shape[-1]
    if (dt.shape != x.shape or dy.shape != x.shape or a.shape != (Di, N)
            or d.shape != (Di,) or b.shape != (B, S, N)
            or c.shape != (B, S, N)):
        raise ValueError(
            f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, dy "
            f"{tuple(dy.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}, c "
            f"{tuple(c.shape)}, d {tuple(d.shape)} do not match"
        )
    if N not in STATES:
        raise ValueError(f"state size N={N}: the kernel takes {STATES}")
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} > {MAX_BATCH} rows")
    if not all(t.is_contiguous() for t in (x, dt, a, d, dy)):
        raise ValueError("x, dt, a, d and dy must be contiguous")
    if b.stride(2) != 1 or c.stride(2) != 1:
        raise ValueError("b and c need their state axis contiguous")
    dx, ddt = torch.empty_like(x), torch.empty_like(dt)
    da, dd = torch.empty_like(a), torch.empty_like(d)
    db = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    dc = torch.empty_like(db)
    if B * Di == 0 or S == 0:
        for t in (dx, ddt, da, dd, db, dc):
            t.zero_()
        return dx, ddt, da, db, dc, dd
    fn, ws_elems = _bwd_kernel()
    ws = torch.empty(ws_elems(B, S, Di, N), dtype=torch.float32,
                     device=x.device)
    err = fn(
        _DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
        b.data_ptr(), c.data_ptr(), d.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(),
        dc.data_ptr(), dd.data_ptr(), ws.data_ptr(), B, S, Di, N,
        b.stride(0), b.stride(1), c.stride(0), c.stride(1),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"selective_scan_bwd launch failed: CUDA error {err}")
    selective_scan_bwd.launches += 1
    return dx, ddt, da, db, dc, dd


selective_scan_bwd.launches = 0


class SelectiveScan(torch.autograd.Function):
    """``y = selective_scan(x, dt, a, b, c, d)`` with the backward kernel.

    ``apply(x, dt, a, b, c, d)``: the forward saves its six inputs (b and
    c as the views they are) and runs the forward kernel; the backward
    launches :func:`selective_scan_bwd`.  On CPU tensors the same steps
    run on the plain versions (``ref.selective_scan`` /
    ``ref.selective_scan_bwd``), on ``meta`` as shape-only stand-ins (the
    dry run), on any other device it raises.  Each kernel call is
    reported to an active op-stream counter as one op
    (``kernels.cost``)."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d):
        case = tuple(x.shape) + (a.shape[-1],)
        with _report("selective_scan", case, x.dtype):
            if x.device.type == "cuda":
                y = selective_scan(x, dt, a, b, c, d)
            elif x.device.type == "cpu":
                y = ref.selective_scan(x, dt, a, b, c, d)
            elif x.device.type == "meta":
                y = torch.empty_like(x)
            else:
                raise ValueError(f"no selective_scan for device {x.device}")
        ctx.save_for_backward(x, dt, a, b, c, d)
        ctx.case = case
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, a, b, c, d = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        with _report("selective_scan_bwd", ctx.case, x.dtype):
            if x.device.type == "cuda":
                return selective_scan_bwd(x, dt, a, b, c, d, dy)
            if x.device.type == "cpu":
                return ref.selective_scan_bwd(x, dt, a, b, c, d, dy)
            return (torch.empty_like(x), torch.empty_like(dt),
                    torch.empty_like(a), torch.empty_like(b),
                    torch.empty_like(c), torch.empty_like(d))


def _report(name, case, dtype):
    nbytes, flops = cost.scan_work(name, case, dtype)
    return cost.kernel(name, flops, nbytes)
