"""MoE router on the GPU: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro.kernels.moe_dispatch.moe_router``
(``_router_kernel``): from router logits ``(T, E)`` f32, softmax gating,
top-k and capacity slots in token order.  The kernel is
``csrc/moe_router.cu`` (its header gives the bound and the design); this
module checks the inputs, picks the launch's plan (:func:`plan`: one CTA,
one thread-block cluster or one cooperative wave of CTAs), allocates the
outputs (in the grid plan with the kernel's scratch of per-CTA counts
behind them), launches the kernel once on PyTorch's current stream and
counts the launches.

The weights' gradient in the logits is a hand kernel too,
``csrc/moe_router_bwd.cu`` (the reference differentiates its plain
``route_topk``; the port routes through a kernel, so its gradient is
one): :func:`moe_router_bwd` launches it, and ``kernels.ops`` binds it
to the routing weights (the custom ops ``repro_torch::router_weights``
and ``repro_torch::moe_router_bwd``).

The wrappers take CUDA tensors only.  CPU tensors go to the plain versions
``repro_torch.kernels.ref.route_topk`` / ``route_topk_bwd`` through
``repro_torch.kernels.ops``.  :func:`moe_router` itself refuses a call
that would need a gradient: ``ops.moe_router`` routes without one and
makes the weights differentiable after.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["moe_router", "moe_router_bwd", "plan", "Plan", "regime_edges",
           "card", "launch", "NAME", "NAME_BWD"]

NAME = "moe_router"
NAME_BWD = "moe_router_bwd"
MAX_EXPERTS = 1024  # 32 per lane of the warp that routes a token
MAX_K = 32  # lane j keeps choice j
CTA, CLUSTER, GRID = 0, 1, 2  # the kernel's modes
MAX_WARPS = 32  # warps a CTA
MAX_CLUSTER = 16  # CTAs a cluster (non-portable above 8)
# The plans' shapes (tools/ab_router.py --plans, PERF.md section 6):
ONE_CTA_T = 16  # up to here one CTA, a token a warp
CLUSTER_WARPS = 12  # warps a CTA at most in the cluster plan
GRID_WARPS = 16  # warps a CTA in the grid plan while a token a warp fits

_fns = None
_bwd = None
_cards: Dict[int, Tuple[int, int]] = {}


class Plan(NamedTuple):
    """One launch: ``mode`` (CTA, CLUSTER or GRID), ``ctas`` CTAs of
    ``warps`` warps, ``tpw`` consecutive tokens a warp."""

    mode: int
    ctas: int
    warps: int
    tpw: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan(T: int, sms: int, max_cluster: int = MAX_CLUSTER) -> Plan:
    """The launch for ``T >= 1`` tokens on a card of ``sms`` SMs that
    holds clusters of up to ``max_cluster`` CTAs.  A decode batch takes
    one CTA, a token a warp; a prefill of up to ``max_cluster`` x
    ``CLUSTER_WARPS`` tokens one cluster, as many CTAs as the card holds,
    a token a warp; longer ones a cooperative grid of at most one CTA a SM
    (one wave): CTAs of ``GRID_WARPS`` warps while a token a warp fits,
    then of 32 warps, each warp routing ``tpw`` tokens."""
    if T <= ONE_CTA_T:
        return Plan(CTA, 1, T, 1)
    if max_cluster > 1 and T <= max_cluster * CLUSTER_WARPS:
        warps = _cdiv(T, max_cluster)
        return Plan(CLUSTER, _cdiv(T, warps), warps, 1)
    warps = GRID_WARPS if T <= sms * GRID_WARPS else MAX_WARPS
    tpw = _cdiv(T, sms * warps)
    return Plan(GRID, _cdiv(T, warps * tpw), warps, tpw)


def regime_edges(max_cluster: int = MAX_CLUSTER) -> Tuple[int, int]:
    """The largest T of the one-CTA plan and of the cluster plan."""
    return ONE_CTA_T, max_cluster * CLUSTER_WARPS


def _kernel():
    global _fns
    if _fns is None:
        lib = build.load(NAME)
        f = lib.repro_moe_router
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, i, i, i, i, i, i, i, i, i, p, p, p]
        f.restype = ctypes.c_int
        mc = lib.repro_moe_router_max_cluster
        mc.argtypes = [i]
        mc.restype = ctypes.c_int
        _fns = f, mc
    return _fns


def card(index: int) -> Tuple[int, int]:
    """(SMs, largest cluster) of CUDA device ``index``, read once."""
    got = _cards.get(index)
    if got is None:
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        with torch.cuda.device(index):  # 32-warp CTAs: one a SM at most
            max_cluster = _kernel()[1](MAX_WARPS)
        got = _cards[index] = (sms, max_cluster)
    return got


def launch(logits: torch.Tensor, k: int, capacity: int, renormalize: bool,
           how: Plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel by the plan ``how``; ``(words, keep)``.

    Two allocations: expert_idx, slot and weight's bits are the three
    (T, k) planes of ``words`` (3, T, k) int32, the first planes of one
    buffer whose further planes hold the grid plan's scratch of per-CTA
    counts, and keep is a bool tensor of its own.  Fewer host operations
    than one buffer carved into four views or four allocations (PERF.md
    section 6)."""
    T, E = logits.shape
    extra = _cdiv(how.ctas * E, T * k) if how.mode == GRID else 0
    words = torch.empty((3 + extra, T, k), dtype=torch.int32,
                        device=logits.device)
    keep = torch.empty((T, k), dtype=torch.bool, device=logits.device)
    err = _kernel()[0](
        logits.data_ptr(), T, E, k, capacity, renormalize, how.mode,
        how.ctas, how.warps, how.tpw, words.data_ptr(), keep.data_ptr(),
        torch._C._cuda_getCurrentRawStream(logits.device.index))
    if err != 0:
        raise RuntimeError(f"moe_router launch failed: CUDA error {err}")
    return words[:3], keep


def unpack(words: torch.Tensor, keep: torch.Tensor):
    """expert_idx, slot, weight (f32) and keep, as ``ref.route_topk``
    returns them, from :func:`moe_router`'s ``(words, keep)``."""
    eidx, slot, bits = words.unbind(0)
    return eidx, slot, bits.view(torch.float32), keep


def moe_router(
    logits: torch.Tensor, *, k: int, capacity: int, renormalize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; returns ``(words, keep)``: expert_idx (T, K)
    int32, slot (T, K) int32 and weight (T, K) f32 as the int32 planes of
    words (3, T, K), and keep (T, K) bool (:func:`unpack` gives the four
    of ``ref.route_topk``).  logits is a contiguous (T, E) f32 tensor."""
    if logits.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel needs CUDA tensors, got {logits.device}"
        )
    if torch.is_grad_enabled() and logits.requires_grad:
        raise RuntimeError(
            "moe_router routes without a gradient: ops.moe_router makes "
            "its weights differentiable after"
        )
    if logits.dtype != torch.float32:
        raise TypeError(f"logits {logits.dtype}: the router takes float32")
    if logits.dim() != 2:
        raise ValueError(f"logits {tuple(logits.shape)}: want (T, E)")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    T, E = logits.shape
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"{E} experts: the kernel takes 1..{MAX_EXPERTS}")
    if not 1 <= k <= min(MAX_K, E):
        raise ValueError(f"k={k}: the kernel takes 1..{min(MAX_K, E)}")
    if T * k >= 2**31:
        raise ValueError(f"T * k = {T * k} choices: fewer than 2**31")
    if T == 0:
        dev = logits.device
        return (torch.empty((3, 0, k), dtype=torch.int32, device=dev),
                torch.empty((0, k), dtype=torch.bool, device=dev))
    out = launch(logits, k, int(capacity), int(bool(renormalize)),
                 plan(T, *card(logits.device.index)))
    moe_router.launches += 1
    return out


moe_router.launches = 0


def _bwd_kernel():
    global _bwd
    if _bwd is None:
        f = build.load(NAME_BWD).repro_moe_router_bwd
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, p, p, p, i, i, i, i, p]
        f.restype = ctypes.c_int
        _bwd = f
    return _bwd


def moe_router_bwd(logits: torch.Tensor, expert_idx: torch.Tensor,
                   dw: torch.Tensor, *, renormalize: bool = True
                   ) -> torch.Tensor:
    """Launch the backward kernel; returns dlogits (T, E) f32, the
    gradient of the routing weights in the logits for their cotangent
    dw.  logits (T, E) f32, expert_idx (T, K) int32 (the forward's
    choices) and dw (T, K) f32, contiguous."""
    if logits.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel needs CUDA tensors, got {logits.device}")
    for name, t in (("expert_idx", expert_idx), ("dw", dw)):
        if t.device != logits.device:
            raise ValueError(f"{name} on {t.device}, logits on {logits.device}")
    if logits.dtype != torch.float32 or dw.dtype != torch.float32:
        raise TypeError(f"logits {logits.dtype}, dw {dw.dtype}: float32")
    if expert_idx.dtype != torch.int32:
        raise TypeError(f"expert_idx {expert_idx.dtype}: int32")
    if logits.dim() != 2:
        raise ValueError(f"logits {tuple(logits.shape)}: want (T, E)")
    T, E = logits.shape
    K = expert_idx.shape[-1] if expert_idx.dim() == 2 else -1
    if expert_idx.shape != (T, K) or dw.shape != (T, K):
        raise ValueError(
            f"expert_idx {tuple(expert_idx.shape)}, dw {tuple(dw.shape)}: "
            f"want ({T}, K)")
    if not 1 <= K <= min(MAX_K, E):
        raise ValueError(f"k={K}: the kernel takes 1..{min(MAX_K, E)}")
    if not all(t.is_contiguous() for t in (logits, expert_idx, dw)):
        raise ValueError("logits, expert_idx and dw must be contiguous")
    out = torch.empty_like(logits)
    if T == 0:
        return out
    err = _bwd_kernel()(
        logits.data_ptr(), expert_idx.data_ptr(), dw.data_ptr(),
        out.data_ptr(), T, E, K, int(bool(renormalize)),
        torch.cuda.current_stream(logits.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_router_bwd launch failed: CUDA error {err}")
    moe_router_bwd.launches += 1
    return out


moe_router_bwd.launches = 0
