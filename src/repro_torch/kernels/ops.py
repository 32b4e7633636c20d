"""Kernel entry points of the port, dispatched on the tensor's device.

The reference picks ``impl="ref"|"pallas"`` by flag.  The port picks by
where the data lies: a CUDA tensor goes to the hand-written kernel (which
raises on what it cannot take — there is no fallback), a CPU tensor to
the plain PyTorch version in ``repro_torch.kernels.ref``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import gascore as _gc
from repro_torch.kernels import moe_router as _moe
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import ssm_scan as _ssm

__all__ = [
    "attention",
    "paged_attention",
    "moe_router",
    "moe_dispatch",
    "moe_combine",
    "ring_shift",
    "perm_put",
    "offset_put",
    "ring_all_gather",
    "ring_reduce_scatter",
    "selective_scan",
    "gated_linear_scan",
]


def _on(x: torch.Tensor, kernel, plain, name: str):
    """CUDA -> the hand kernel, CPU -> the plain version, else raise."""
    if x.device.type == "cuda":
        return kernel
    if x.device.type == "cpu":
        return plain
    raise ValueError(f"no {name} for device {x.device}")


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Differentiable blockwise attention: q (B, Hq, Sq, D) against k, v
    (B, Hkv, Sk, D), contiguous.  ``FlashAttention`` dispatches on the
    device in its forward and backward: on CUDA the forward, dK/dV and dQ
    kernels, on the CPU their plain versions, elsewhere it raises."""
    return _fab.FlashAttention.apply(q, k, v, causal, window, scale,
                                     block_q, block_k)


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention through a page table: q (B, Hq, D) against
    (P, T, Hkv, D) physical pages addressed by page_table (B, NP), masked
    at lengths (B,)."""
    if q.device.type == "cuda":
        return _pa.paged_attention(
            q, k_pages, v_pages, page_table, lengths, scale=scale
        )
    if q.device.type == "cpu":
        return ref.paged_attention(
            q, k_pages, v_pages, page_table, lengths, scale=scale
        )
    raise ValueError(f"no paged_attention for device {q.device}")


def moe_router(
    logits: torch.Tensor, *, k: int, capacity: int, renormalize: bool = True
):
    """Top-k routing with capacity slots in token order: expert_idx,
    slot, weight and keep, each (T, K), from (T, E) f32 logits."""
    return _on(logits, _moe.moe_router, ref.route_topk, "moe_router")(
        logits, k=k, capacity=capacity, renormalize=renormalize
    )


# dispatch/combine are the plain scatter and gather on both devices, as
# in the reference (where XLA handles them)
moe_dispatch = ref.moe_dispatch
moe_combine = ref.moe_combine


def selective_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
    *,
    final_state: bool = False,
):
    """The mamba-1 scan: y (B, S, Di) in x's dtype, and with
    ``final_state`` also h_S (B, Di, N) f32.  On CUDA one kernel launch
    computes both; on the CPU the plain scan and, for the state, the
    reference's second scan (``ref.mamba_final_state``)."""
    if x.device.type == "cuda":
        return _ssm.selective_scan(x, dt, a, b, c, d, final_state=final_state)
    if x.device.type == "cpu":
        y = ref.selective_scan(x, dt, a, b, c, d)
        if final_state:
            return y, ref.mamba_final_state(x, dt, a, b)
        return y
    raise ValueError(f"no selective_scan for device {x.device}")


def gated_linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1, every h_t in b's dtype."""
    return _on(b, _rglru.gated_linear_scan, ref.gated_linear_scan,
               "gated_linear_scan")(a, b)


# --------------------------------------------------------------------------- #
# GAScore transport (global rank-stacked tensors, see kernels/gascore.py)
# --------------------------------------------------------------------------- #
def ring_shift(x: torch.Tensor, k: int) -> torch.Tensor:
    return _on(x, _gc.ring_shift, ref.ring_shift, "ring_shift")(x, k)


def perm_put(x: torch.Tensor, dst: Sequence[int]) -> torch.Tensor:
    """Bijections only, on either device (the GAScore contract)."""
    if sorted(int(d) for d in dst) != list(range(x.shape[0])):
        raise ValueError(f"perm_put requires a bijection, got {tuple(dst)}")
    return _on(x, _gc.perm_put, ref.perm_put, "perm_put")(x, dst)


def offset_put(
    seg: torch.Tensor, data: torch.Tensor, offset: torch.Tensor, k: int
) -> torch.Tensor:
    """On CUDA the kernel writes into ``seg`` in place and returns it; the
    plain version returns a new segment.  Callers use the return value."""
    return _on(seg, _gc.offset_put, ref.offset_put, "offset_put")(
        seg, data, offset, k
    )


def ring_all_gather(x: torch.Tensor) -> torch.Tensor:
    return _on(x, _gc.ring_all_gather, ref.all_gather, "ring_all_gather")(x)


def ring_reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    return _on(x, _gc.ring_reduce_scatter, ref.reduce_scatter,
               "ring_reduce_scatter")(x)
