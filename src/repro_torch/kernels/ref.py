"""Plain PyTorch versions of the port's kernels (the oracles).

Counterparts of ``repro.kernels.ref``: simple, unfused, obviously right.
The CPU tests hold them against the JAX oracles, and ``chip_smoke.py``
holds each hand-written kernel against them on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["attention", "paged_attention"]

NEG_INF = -1e30


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Unfused softmax attention with GQA/causal/window; f32 internals.

    q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D)."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D**0.5)
    kx = k.repeat_interleave(group, dim=1)
    vx = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, kx.float())
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
        if not causal:
            mask &= (kpos - qpos) < window
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # fully-masked rows give uniform p; zero them like the kernel does
    any_visible = mask.any(dim=-1)[None, None, :, None]
    out = torch.einsum("bhqk,bhkd->bhqd", p, vx.float())
    out = torch.where(any_visible, out, 0.0)
    return out.to(q.dtype)


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention reading K/V through a page table (unfused oracle).

    q: (B, Hq, D) — one query token per request.
    k_pages / v_pages: (P, T, Hkv, D) — the physical page pool.
    page_table: (B, NP) int32 — request b's logical page p lives in
      physical page ``page_table[b, p]``; entries past the live length may
      point at any physical page (they are masked).
    lengths: (B,) int32 — number of live cache positions per request.
    """
    B, Hq, D = q.shape
    _, T, Hkv, _ = k_pages.shape
    NP = page_table.shape[1]
    S = NP * T
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D**0.5)
    idx = page_table.long()
    # gather: (B, NP, T, Hkv, D) -> (B, Hkv, S, D)
    kd = k_pages[idx].reshape(B, S, Hkv, D).transpose(1, 2)
    vd = v_pages[idx].reshape(B, S, Hkv, D).transpose(1, 2)
    kx = kd.repeat_interleave(group, dim=1)  # (B, Hq, S, D)
    vx = vd.repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhsd->bhs", q.float() * scale, kx.float())
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None].long()
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # zero V at masked positions too: masked probabilities are ~0 but
    # 0 * NaN = NaN, and padded table slots may point at garbage pages
    vx = torch.where(valid[:, None, :, None], vx.float(), 0.0)
    out = torch.einsum("bhs,bhsd->bhd", p, vx)
    any_visible = valid.any(dim=-1)[:, None, None]
    return torch.where(any_visible, out, 0.0).to(q.dtype)
