"""Slices at a rank-dependent start, for code lifted over ranks by vmap.

The reference slices with ``lax.dynamic_slice``/``dynamic_update_slice``
whose start depends on the rank.  Python slicing cannot take a start that
``torch.func.vmap`` batches, so these helpers index with tensors (gather
and a select over an ``arange`` mask) instead.  Like JAX they CLAMP the
start to ``[0, len - size]``; the update is a select, so every byte that is
not overwritten keeps its bits.  All act on the leading dimension.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["as_i32", "dynamic_slice", "dynamic_update_slice", "take"]


def as_i32(v: Any, device: torch.device) -> torch.Tensor:
    """``jnp.asarray(v, jnp.int32)``: a tensor keeps its batching.  A
    Python int becomes a device-side fill, which copies nothing from the
    host.  A sequence (caller-chosen index lists, unbounded in number) is
    staged in pinned host memory and copied without blocking: a copy from
    pageable memory would make the host wait for the stream to drain, and
    the pinned block is not reused before its copy has run."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int32)
    a = np.asarray(v, dtype=np.int64)
    if a.ndim == 0:
        return torch.full((), int(a), dtype=torch.int32, device=device)
    host = torch.from_numpy(a.astype(np.int32))
    if torch.device(device).type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _start(start: Any, length: int, size: int, device) -> torch.Tensor:
    s = as_i32(start, device).to(torch.int64)
    return s.clamp(0, max(length - size, 0))


def _bcast(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (x.dim() - 1))


def dynamic_slice(x: torch.Tensor, start: Any, size: int) -> torch.Tensor:
    """``x[start:start+size]`` with a clamped, possibly batched start."""
    s = _start(start, x.shape[0], size, x.device)
    idx = s + torch.arange(size, device=x.device)
    return x.index_select(0, idx)


def dynamic_update_slice(
    x: torch.Tensor, update: torch.Tensor, start: Any
) -> torch.Tensor:
    """``x`` with rows ``[start, start+len(update))`` replaced (clamped)."""
    n, u = x.shape[0], update.shape[0]
    s = _start(start, n, u, x.device)
    pos = torch.arange(n, device=x.device)
    inside = (pos >= s) & (pos < s + u)
    src = (pos - s).clamp(0, max(u - 1, 0))
    vals = update.to(x.dtype).index_select(0, src)
    return torch.where(_bcast(inside, x), vals, x)


def take(x: torch.Tensor, i: Any) -> torch.Tensor:
    """``x[i]`` along the leading dimension, ``i`` possibly batched."""
    return dynamic_slice(x, i, 1)[0]
