"""Kernel entry points of the port, dispatched on the tensor's device.

The reference picks ``impl="ref"|"pallas"`` by flag.  The port picks by
where the data lies: a CUDA tensor goes to the hand-written kernel (which
raises on what it cannot take — there is no fallback), a CPU tensor to
the plain PyTorch version in ``repro_torch.kernels.ref``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref

__all__ = ["paged_attention"]


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
