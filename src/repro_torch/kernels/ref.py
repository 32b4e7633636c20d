"""Plain PyTorch versions of the port's kernels (the oracles).

Counterparts of ``repro.kernels.ref``: simple, unfused, obviously right.
The CPU tests hold them against the JAX oracles, and ``chip_smoke.py``
holds each hand-written kernel against them on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

__all__ = [
    "ring_shift",
    "perm_put",
    "offset_put",
    "all_gather",
    "reduce_scatter",
    "all_reduce",
    "all_to_all",
    "attention",
    "paged_attention",
]

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# GAScore transport: every function acts on the GLOBAL rank-stacked tensor
# (n_nodes, *local), as the reference's numpy oracles do
# --------------------------------------------------------------------------- #
def ring_shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """Rank (i+k) % n receives rank i's data: a roll by +k along dim 0."""
    return torch.roll(x, k % x.shape[0], 0)


def perm_put(x: torch.Tensor, dst: Sequence[Optional[int]]) -> torch.Tensor:
    """Rank i's data lands on rank ``dst[i]``; ``None`` sends nowhere and
    ranks that receive nothing hold zeros."""
    n = x.shape[0]
    inv = [-1] * n
    for s, d in enumerate(dst):
        if d is not None:
            inv[int(d)] = s
    src = torch.tensor([max(s, 0) for s in inv], device=x.device)
    got = x.index_select(0, src)
    if min(inv) >= 0:
        return got
    mask = torch.tensor([s >= 0 for s in inv], device=x.device)
    mask = mask.reshape((n,) + (1,) * (x.dim() - 1))
    return torch.where(mask, got, torch.zeros_like(got))


def offset_put(
    seg: torch.Tensor, data: torch.Tensor, offset: torch.Tensor, k: int
) -> torch.Tensor:
    """AMLong: rank i writes ``data[i]`` (L, ...) into the partition of rank
    (i+k) % n of ``seg`` (n, S, ...) at leading row ``offset[i]``.  Returns
    a new segment; offsets outside [0, S-L] are clamped, as JAX clamps."""
    n, S = seg.shape[0], seg.shape[1]
    L = data.shape[1]
    off = offset.reshape(-1).expand(n).long().clamp(0, S - L)
    dst = (torch.arange(n, device=seg.device) + k) % n
    rows = off[:, None] + torch.arange(L, device=seg.device)[None, :]
    out = seg.clone()
    out[dst[:, None], rows] = data
    return out


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """(n, m, ...) locals -> every rank holds the (n*m, ...) concatenation."""
    n = x.shape[0]
    full = x.reshape((1, -1) + tuple(x.shape[2:]))
    return full.expand((n,) + tuple(full.shape[1:])).contiguous()


def reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    """(n, n*m, ...) contributions -> rank c holds the sum over ranks of
    chunk c, summed in RING order: the packet for chunk c starts at rank
    c+1 and adds each rank's contribution on its way round, so
    ``acc = x[c+1][c]; acc += x[c+2][c]; ...; acc += x[c][c]``, in the
    input dtype — the schedule of the reference's ring reduce-scatter."""
    n = x.shape[0]
    m = x.shape[1] // n
    blocks = x.reshape((n, n, m) + tuple(x.shape[2:]))
    c = torch.arange(n, device=x.device)
    acc = blocks[(c + 1) % n, c]
    for j in range(2, n + 1):
        acc = acc + blocks[(c + j) % n, c]
    return acc


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    s = x.sum(dim=0, keepdim=True).to(x.dtype)  # ints wrap as XLA's psum
    return s.expand(x.shape).contiguous()


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """(n, n*m, ...) -> out[r, s*m:(s+1)*m] = x[s, r*m:(r+1)*m]."""
    n = x.shape[0]
    m = x.shape[1] // n
    blocks = x.reshape((n, n, m) + tuple(x.shape[2:]))
    return blocks.transpose(0, 1).reshape(x.shape)


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
