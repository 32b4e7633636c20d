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
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref

__all__ = [
    "attention",
    "paged_attention",
    "ring_shift",
    "perm_put",
    "offset_put",
    "ring_all_gather",
    "ring_reduce_scatter",
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
