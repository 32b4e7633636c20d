"""MoE router on the GPU: the hand-written CUDA kernel's wrapper.

Replaces the TPU kernel ``repro.kernels.moe_dispatch.moe_router``
(``_router_kernel``): from router logits ``(T, E)`` f32, softmax gating,
top-k and capacity slots in token order.  The kernel is
``csrc/moe_router.cu`` (its header gives the bound and the design); this
module checks the inputs, allocates the outputs and the scratch of block
counts, launches it on PyTorch's current stream and counts the launches.

The wrapper takes CUDA tensors only.  CPU tensors go to the plain version
``repro_torch.kernels.ref.route_topk`` through ``repro_torch.kernels.ops``.
There is no backward kernel (the reference routes forward only): a call
that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

__all__ = ["moe_router", "tokens_per_warp", "NAME"]

NAME = "moe_router"
MAX_EXPERTS = 1024  # 32 per lane of the warp that routes a token
MAX_K = 32  # lane j keeps choice j

_fns = None


def _kernel():
    global _fns
    if _fns is None:
        lib = build.load(NAME)
        f = lib.repro_moe_router
        p, i = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [p, i, i, i, i, i, i, p, p, p, p, p, p]
        f.restype = ctypes.c_int
        nb = lib.repro_moe_router_blocks
        nb.argtypes = [i, i]
        nb.restype = ctypes.c_int
        _fns = f, nb
    return _fns


def tokens_per_warp(T: int, sms: int) -> int:
    """Tokens each warp routes: 1 while 8-token blocks fit one wave of the
    ``sms`` SMs, up to 8 (64-token blocks) for long prefills."""
    return max(1, min(8, -(-T // (8 * sms))))


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
    dev = logits.device
    eidx = torch.empty((T, k), dtype=torch.int32, device=dev)
    slot = torch.empty((T, k), dtype=torch.int32, device=dev)
    weight = torch.empty((T, k), dtype=torch.float32, device=dev)
    keep = torch.empty((T, k), dtype=torch.bool, device=dev)
    if T == 0:
        return eidx, slot, weight, keep
    launch, blocks = _kernel()
    tpw = tokens_per_warp(
        T, torch.cuda.get_device_properties(dev).multi_processor_count)
    nblocks = blocks(T, tpw)
    counts = (torch.empty((nblocks, E), dtype=torch.int32, device=dev)
              if nblocks > 1 else None)
    err = launch(
        logits.data_ptr(), T, E, k, int(capacity), int(bool(renormalize)),
        tpw, eidx.data_ptr(), slot.data_ptr(), weight.data_ptr(),
        keep.data_ptr(), None if counts is None else counts.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"moe_router launch failed: CUDA error {err}")
    moe_router.launches += 1
    return eidx, slot, weight, keep


moe_router.launches = 0
