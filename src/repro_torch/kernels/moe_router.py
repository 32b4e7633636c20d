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

The wrapper takes CUDA tensors only.  CPU tensors go to the plain version
``repro_torch.kernels.ref.route_topk`` through ``repro_torch.kernels.ops``.
There is no backward kernel (the reference routes forward only): a call
that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["moe_router", "plan", "Plan", "regime_edges", "card", "launch",
           "NAME"]

NAME = "moe_router"
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
           how: Plan) -> Tuple[torch.Tensor, ...]:
    """One launch of the kernel by the plan ``how``; the four outputs.

    Two allocations: expert_idx, slot and weight are the first three
    (T, k) planes of one int32 buffer, whose further planes hold the grid
    plan's scratch of per-CTA counts, and keep is a bool tensor of its
    own.  Fewer host operations than one buffer carved into four views
    or four allocations (PERF.md section 6)."""
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
    eidx, slot, weight = words.unbind(0)[:3]
    return eidx, slot, weight.view(torch.float32), keep


def moe_router(
    logits: torch.Tensor, *, k: int, capacity: int, renormalize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel; returns expert_idx (T, K) int32, slot (T, K)
    int32, weight (T, K) f32 and keep (T, K) bool, as ``ref.route_topk``.
    logits is a contiguous (T, E) f32 tensor."""
    if logits.device.type != "cuda":
        raise ValueError(
            f"the CUDA kernel needs CUDA tensors, got {logits.device}"
        )
    if torch.is_grad_enabled() and logits.requires_grad:
        raise RuntimeError(
            "moe_router has no backward kernel: call it under "
            "torch.no_grad(), or on the CPU for differentiable weights"
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
        return (torch.empty((0, k), dtype=torch.int32, device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev),
                torch.empty((0, k), dtype=torch.float32, device=dev),
                torch.empty((0, k), dtype=torch.bool, device=dev))
    out = launch(logits, k, int(capacity), int(bool(renormalize)),
                 plan(T, *card(logits.device.index)))
    moe_router.launches += 1
    return out


moe_router.launches = 0
