"""Plain PyTorch versions of the port's kernels (the oracles).

Counterparts of ``repro.kernels.ref``: simple, unfused, obviously right.
The CPU tests hold them against the JAX oracles, and ``chip_smoke.py``
holds each hand-written kernel against them on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.compat import device_const

__all__ = [
    "ring_shift",
    "perm_put",
    "offset_put",
    "all_gather",
    "reduce_scatter",
    "all_reduce",
    "all_to_all",
    "attention",
    "flash_attention_fwd",
    "flash_attention_dkv",
    "flash_attention_dq",
    "flash_attention_bwd",
    "paged_attention",
    "paged_attention_split",
    "route_topk",
    "route_topk_bwd",
    "moe_dispatch",
    "moe_combine",
    "selective_scan",
    "mamba_final_state",
    "gated_linear_scan",
    "selective_scan_bwd",
    "gated_linear_scan_bwd",
    "selective_scan_chunked",
    "gated_linear_scan_chunked",
]

NEG_INF = -1e30
MERGE_SPLITS = 8  # the paged kernel's merge folds this many splits at once


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
    src = device_const([max(s, 0) for s in inv], torch.int64, x.device)
    got = x.index_select(0, src)
    if min(inv) >= 0:
        return got
    mask = device_const([s >= 0 for s in inv], torch.bool, x.device)
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


def attention_mask(
    Sq: int, Sk: int, causal: bool, window: Optional[int], device
) -> torch.Tensor:
    """(Sq, Sk) bool: which keys each query sees, q and k positions both
    counted from 0 (``_mask`` of the reference's flash kernels)."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
        if not causal:
            mask &= (kpos - qpos) < window
    return mask


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
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # fully-masked rows give uniform p; zero them like the kernel does
    any_visible = mask.any(dim=-1)[None, None, :, None]
    out = torch.einsum("bhqk,bhkd->bhqd", p, vx.float())
    out = torch.where(any_visible, out, 0.0)
    return out.to(q.dtype)


# --------------------------------------------------------------------------- #
# flash attention: the forward with its log-sum-exp, and the two backward
# passes, each the plain version of one CUDA kernel (dense, f32 inside)
# --------------------------------------------------------------------------- #
def _scores(q, k, scale):
    """(q * scale) . k^T in f32, k repeated over the GQA group, and the
    f32 ``q * scale`` and repeated k."""
    group = q.shape[1] // k.shape[1]
    qs = q.float() * scale
    kx = k.float().repeat_interleave(group, dim=1)
    return qs @ kx.transpose(-1, -2), qs, kx


def _probs(q, k, lse, causal, window, scale):
    """p = exp(s - lse) under the mask (0 where hidden), recomputed from the
    forward's log-sum-exp, as the backward kernels do."""
    s, qs, kx = _scores(q, k, scale)
    mask = attention_mask(q.shape[2], k.shape[2], causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    return p, qs, kx


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the attention in q's dtype and the row log-sum-exp
    ``m + log(l)`` in f32, with ``out = 0`` and ``lse = -1e30 + log(1)``
    on a row that sees no key (``flash_attention.py:98-102``)."""
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / (D**0.5)
    group = q.shape[1] // k.shape[1]
    s, _, _ = _scores(q, k, scale)
    mask = attention_mask(q.shape[2], k.shape[2], causal, window, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)  # stays -1e30 on a row with no visible key
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    denom = torch.where(l == 0.0, 1.0, l)
    vx = v.float().repeat_interleave(group, dim=1)
    out = (p @ vx) / denom[..., None]
    return out.to(q.dtype), m + torch.log(denom)


def flash_attention_dkv(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` in k's and v's dtype: ``dV = p^T dO`` and
    ``dK = dS^T (q * scale)`` with ``dS = p * (dO V^T - delta)``, summed
    over each KV head's group of q heads (``flash_attention_bwd.py:93-118``)."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if scale is None:
        scale = 1.0 / (D**0.5)
    group = Hq // Hkv
    p, qs, _ = _probs(q, k, lse, causal, window, scale)
    do = dout.float()
    vx = v.float().repeat_interleave(group, dim=1)
    ds = p * (do @ vx.transpose(-1, -2) - delta[..., None])
    dv = (p.transpose(-1, -2) @ do).reshape(B, Hkv, group, Sk, D).sum(2)
    dk = (ds.transpose(-1, -2) @ qs).reshape(B, Hkv, group, Sk, D).sum(2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dkv_f64(q, k, v, dout, lse, delta, *, causal=True,
                            window=None, scale=None):
    """``(dk, dv)`` as :func:`flash_attention_dkv` computes them, but
    summed in f64 and left in f64, one q head at a time: the exact sums
    that a bf16 kernel and the f32 plain version are both held to where
    each element sums many terms (a long GQA group)."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if scale is None:
        scale = 1.0 / (D**0.5)
    group = Hq // Hkv
    mask = attention_mask(Sq, Sk, causal, window, q.device)
    dk = torch.zeros((B, Hkv, Sk, D), dtype=torch.float64, device=q.device)
    dv = torch.zeros_like(dk)
    for b in range(B):
        for h in range(Hq):
            qs, kh = q[b, h].double() * scale, k[b, h // group].double()
            do = dout[b, h].double()
            p = torch.where(mask, torch.exp(qs @ kh.T - lse[b, h].double()
                                            [:, None]), 0.0)
            ds = p * (do @ v[b, h // group].double().T
                      - delta[b, h].double()[:, None])
            dv[b, h // group] += p.T @ do
            dk[b, h // group] += ds.T @ qs
    return dk, dv


def flash_attention_dq(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """dq in q's dtype: ``dS K scale`` (``flash_attention_bwd.py:158-176``)."""
    D = q.shape[-1]
    if scale is None:
        scale = 1.0 / (D**0.5)
    group = q.shape[1] // k.shape[1]
    p, _, kx = _probs(q, k, lse, causal, window, scale)
    do = dout.float()
    vx = v.float().repeat_interleave(group, dim=1)
    ds = p * (do @ vx.transpose(-1, -2) - delta[..., None])
    return ((ds @ kx) * scale).to(q.dtype)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's output and log-sum-exp, with
    ``delta = rowsum(dO * O)`` in f32."""
    delta = (dout.float() * out.float()).sum(dim=-1)
    kw = dict(causal=causal, window=window, scale=scale)
    dk, dv = flash_attention_dkv(q, k, v, dout, lse, delta, **kw)
    dq = flash_attention_dq(q, k, v, dout, lse, delta, **kw)
    return dq, dk, dv


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


def paged_attention_split(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    scale: Optional[float] = None,
    pages_per_split: int,
) -> torch.Tensor:
    """``paged_attention`` partitioned and merged as the CUDA kernel does.

    Each request's positions are cut into splits of ``pages_per_split``
    pages.  Each split that starts before the length takes its softmax
    alone, in f32: its max ``m_s`` (of scores masked to -1e30 past the
    length), ``l_s = sum exp(s - m_s)`` and ``acc_s = sum exp(s - m_s) v``
    over its live positions.  The splits merge in order, 8 at a time:
    ``m = max m_s``, ``l = sum l_s exp(m_s - m)``, ``acc = sum acc_s
    exp(m_s - m)`` over the first 8, each later 8 folded in with the
    running ``m``, ``l`` and ``acc`` rescaled to their new max; ``out = acc
    / l`` (0 where ``l`` is 0, i.e. a length of 0)."""
    B, Hq, D = q.shape
    _, T, Hkv, _ = k_pages.shape
    NP = page_table.shape[1]
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D**0.5)
    ns = -(-NP // pages_per_split)
    split = pages_per_split * T
    # pad the table to whole splits; the padded slots lie past every length
    idx = torch.zeros((B, ns * pages_per_split), dtype=torch.long,
                      device=q.device)
    idx[:, :NP] = page_table.long()
    S = ns * split
    kx = k_pages[idx].reshape(B, S, Hkv, D).transpose(1, 2)
    vx = v_pages[idx].reshape(B, S, Hkv, D).transpose(1, 2)
    kx = kx.repeat_interleave(group, dim=1).float()  # (B, Hq, S, D)
    vx = vx.repeat_interleave(group, dim=1).float()
    length = torch.clamp(lengths.long(), max=NP * T)
    valid = torch.arange(S, device=q.device)[None, :] < length[:, None]
    s = torch.einsum("bhd,bhsd->bhs", q.float() * scale, kx)
    s = torch.where(valid[:, None, :], s, NEG_INF).reshape(B, Hq, ns, split)
    vs = torch.where(valid[:, None, :, None], vx, 0.0)
    vs = vs.reshape(B, Hq, ns, split, D)
    live = valid.reshape(B, ns, split)[:, None]  # (B, 1, ns, split)
    m_s = s.max(dim=-1).values  # (B, Hq, ns)
    p = torch.where(live, torch.exp(s - m_s[..., None]), 0.0)
    l_s = p.sum(dim=-1)
    acc_s = torch.einsum("bhnt,bhntd->bhnd", p, vs)
    started = live.any(dim=-1)  # splits that start before the length
    m_s = torch.where(started, m_s, NEG_INF)
    m = torch.full((B, Hq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hq), device=q.device)
    acc = torch.zeros((B, Hq, D), device=q.device)
    for c in range(0, ns, MERGE_SPLITS):
        chunk = slice(c, c + MERGE_SPLITS)
        cm = torch.maximum(m, m_s[..., chunk].max(dim=-1).values)
        r = torch.exp(m - cm)
        e = torch.where(started[..., chunk], torch.exp(m_s[..., chunk] - cm[
            ..., None]), 0.0)
        l = l * r + (l_s[..., chunk] * e).sum(dim=-1)
        acc = acc * r[..., None] + (acc_s[..., chunk, :] * e[..., None]).sum(
            dim=-2)
        m = cm
    out = torch.where(l[..., None] > 0, acc / torch.where(l > 0, l, 1.0)[
        ..., None], 0.0)
    return out.to(q.dtype)


# --------------------------------------------------------------------------- #
# MoE routing
# --------------------------------------------------------------------------- #
def route_topk(
    logits: torch.Tensor, *, k: int, capacity: int, renormalize: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing with capacity slots in token order (the oracle).

    f32 softmax over the E experts of each of the T tokens, then the k
    largest probabilities, equal ones lower expert index first (as
    ``jax.lax.top_k``; a stable descending sort keeps that order), the
    weights optionally renormalised by ``max(sum, 1e-9)``.  ``slot`` is the
    exclusive rank of each (token, choice) among the choices of the same
    expert, in flat token-major order; ``keep = slot < capacity``.
    Returns expert_idx (T, K) int32, slot (T, K) int32, weight (T, K) f32
    and keep (T, K) bool."""
    T, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, e = w[:, :k], e[:, :k]
    if renormalize:
        w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    oh = torch.nn.functional.one_hot(e.reshape(-1), E)  # (T*K, E)
    excl = torch.cumsum(oh, dim=0) - oh
    slot = (excl * oh).sum(-1)
    keep = slot < capacity
    return (
        e.to(torch.int32),
        slot.reshape(T, k).to(torch.int32),
        w.float(),
        keep.reshape(T, k),
    )


def route_topk_bwd(
    logits: torch.Tensor,
    expert_idx: torch.Tensor,
    dw: torch.Tensor,
    *,
    renormalize: bool = True,
    acc: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The gradient of :func:`route_topk`'s weights in the logits: dlogits
    (T, E) from the chosen experts ``expert_idx`` (T, K) and the weights'
    cotangent ``dw`` (T, K), computed and returned in ``acc`` (f32; f64
    gives the exact values a kernel is held to).  p = softmax(logits) is
    recomputed; dw is carried back through the renormalisation ``w = p_K
    / max(s, 1e-9)`` (the clamp passes its gradient where ``s >= 1e-9``,
    as ``torch.clamp`` does) onto the K chosen p, scattered into g (T,
    E), and ``dlogits = p * (g - <p, g>)``."""
    p = torch.softmax(logits.to(acc), dim=-1)
    idx = expert_idx.long()
    pk = p.gather(1, idx)
    dw = dw.to(acc)
    if renormalize:
        s = pk.sum(dim=-1, keepdim=True)
        sc = torch.clamp(s, min=1e-9)
        dpk = dw / sc - torch.where(s >= 1e-9, (dw * pk).sum(
            dim=-1, keepdim=True) / (sc * sc), 0.0)
    else:
        dpk = dw
    g = torch.zeros_like(p).scatter(1, idx, dpk)
    return p * (g - (pk * dpk).sum(dim=-1, keepdim=True))


def moe_dispatch(
    tokens: torch.Tensor,
    expert_idx: torch.Tensor,
    slot: torch.Tensor,
    keep: torch.Tensor,
    *,
    n_experts: int,
    capacity: int,
) -> torch.Tensor:
    """(T, D) tokens -> (E, C, D) expert buffers (dropped rows zero).  A
    dropped choice adds zeros at (e, 0), as the reference does; kept
    (e, s) pairs are unique, so the accumulation is exact in any order."""
    T, D = tokens.shape
    buf = tokens.new_zeros((n_experts, capacity, D))
    for j in range(expert_idx.shape[1]):
        e = expert_idx[:, j].long()
        s = torch.where(keep[:, j], slot[:, j], 0).long()
        contrib = torch.where(keep[:, j, None], tokens, 0)
        buf.index_put_((e, s), contrib, accumulate=True)
    return buf


def moe_combine(
    expert_out: torch.Tensor,
    expert_idx: torch.Tensor,
    slot: torch.Tensor,
    weight: torch.Tensor,
    keep: torch.Tensor,
) -> torch.Tensor:
    """(E, C, D) expert outputs -> (T, D) weighted combination.  A dropped
    choice's slot (>= C) is clamped to C - 1, where the reference's gather
    clamps it silently (a CUDA index out of range is a fault), and its row
    is multiplied by a zero weight, as there: a NaN in that row gives NaN.
    The K choices are summed in order from zero, in f32."""
    C = expert_out.shape[1]
    rows = expert_out[expert_idx.long(), slot.clamp(max=C - 1).long()]
    w = torch.where(keep, weight, 0.0)
    out = torch.zeros(rows.shape[:1] + rows.shape[2:], dtype=torch.float32,
                      device=rows.device)
    for j in range(rows.shape[1]):
        out = out + rows[:, j] * w[:, j, None]
    return out.to(expert_out.dtype)


# --------------------------------------------------------------------------- #
# scans (the mamba-1 selective scan and the RG-LRU gated linear scan)
# --------------------------------------------------------------------------- #
def selective_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
) -> torch.Tensor:
    """The mamba-1 recurrence over axis 1, f32 inside, y in x's dtype:

      h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,
      y_t = C_t . h_t + D * x_t,

    x, dt (B, S, Di); a (Di, N); b, c (B, S, N); d (Di,); h_0 = 0."""
    B, S, Di = x.shape
    xf, dtf, af = x.float(), dt.float(), a.float()
    bf, cf, df = b.float(), c.float(), d.float()
    h = torch.zeros((B, Di, a.shape[1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        xt, dtt = xf[:, t], dtf[:, t]
        decay = torch.exp(dtt[..., None] * af[None])  # (B, Di, N)
        drive = (dtt * xt)[..., None] * bf[:, t, None, :]
        h = decay * h + drive
        ys.append((h * cf[:, t, None, :]).sum(-1) + df[None] * xt)
    if not ys:
        return torch.empty_like(x)
    return torch.stack(ys, 1).to(x.dtype)


def mamba_final_state(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """The state h_S (B, Di, N) f32 the same recurrence ends in (the
    reference's ``_mamba_final_state``, a second scan without the y)."""
    B, S, Di = x.shape
    xf, dtf, af, bf = x.float(), dt.float(), a.float(), b.float()
    h = torch.zeros((B, Di, a.shape[1]), dtype=torch.float32, device=x.device)
    for t in range(S):
        decay = torch.exp(dtf[:, t, :, None] * af[None])
        h = decay * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
    return h


def gated_linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 of (B, S, W), f32 inside,
    h_0 = 0; returns every h_t in b's dtype."""
    af, bf = a.float(), b.float()
    h = torch.zeros_like(af[:, 0])
    ys = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        ys.append(h)
    if not ys:
        return torch.empty_like(b)
    return torch.stack(ys, 1).to(b.dtype)


def selective_scan_bwd(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
    dy: torch.Tensor,
    chunk: int = 16,
    *,
    acc: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`selective_scan` for the cotangent ``dy`` of
    y: ``(dx, ddt, dA, dB, dC, dD)``, the algorithm of the CUDA kernel
    (``csrc/ssm_scan_bwd.cu``) in plain torch, summed in ``acc``.

    The forward runs once, keeping the state at the start of every
    ``chunk`` of steps; the chunks are then walked in reverse, h
    recomputed inside each from its start state, and the reverse state
    scan ``gh_t = C_t dy_t + exp(dt_{t+1} A) gh_{t+1}`` run through it:

      dx_t  = D dy_t + dt_t (B_t . gh_t),
      ddt_t = x_t (B_t . gh_t) + sum_n gh_t h_{t-1} exp(dt_t A) A,
      dA    = sum_{b,t} gh_t h_{t-1} exp(dt_t A) dt_t,
      dB_t  = sum_i dt_t x_t gh_t,   dC_t = sum_i dy_t h_t,
      dD    = sum_{b,t} dy_t x_t.

    Results in the inputs' dtypes with ``acc`` f32; left in ``acc``
    otherwise (an f64 ``acc`` gives the exact sums a kernel is held to)."""
    Bn, S, Di = x.shape
    N = a.shape[1]
    xf, dtf, af = x.to(acc), dt.to(acc), a.to(acc)
    bf, cf, df, dyf = b.to(acc), c.to(acc), d.to(acc), dy.to(acc)
    chunk = max(1, int(chunk))

    def step(h, t):
        decay = torch.exp(dtf[:, t, :, None] * af[None])
        return decay * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]

    h = torch.zeros((Bn, Di, N), dtype=acc, device=x.device)
    starts = []
    for t in range(S):
        if t % chunk == 0:
            starts.append(h)
        h = step(h, t)
    dx = torch.zeros((Bn, S, Di), dtype=acc, device=x.device)
    ddt = torch.zeros_like(dx)
    db = torch.zeros((Bn, S, N), dtype=acc, device=x.device)
    dc = torch.zeros_like(db)
    da = torch.zeros((Di, N), dtype=acc, device=x.device)
    r = torch.zeros((Bn, Di, N), dtype=acc, device=x.device)
    for ci in reversed(range(len(starts))):
        t0 = ci * chunk
        hs = [starts[ci]]
        for t in range(t0, min(S, t0 + chunk)):
            hs.append(step(hs[-1], t))
        for t in reversed(range(t0, min(S, t0 + chunk))):
            decay = torch.exp(dtf[:, t, :, None] * af[None])
            hprev, ht = hs[t - t0], hs[t - t0 + 1]
            gh = cf[:, t, None, :] * dyf[:, t, :, None] + r
            sb = (gh * bf[:, t, None, :]).sum(-1)
            dx[:, t] = df[None] * dyf[:, t] + dtf[:, t] * sb
            gdec = gh * hprev * decay
            ddt[:, t] = xf[:, t] * sb + (gdec * af[None]).sum(-1)
            da = da + (gdec * dtf[:, t, :, None]).sum(0)
            db[:, t] = ((dtf[:, t] * xf[:, t])[..., None] * gh).sum(1)
            dc[:, t] = (dyf[:, t, :, None] * ht).sum(1)
            r = decay * gh
    dd = (dyf * xf).sum((0, 1))
    outs = (dx, ddt, da, db, dc, dd)
    if acc != torch.float32:
        return outs
    return tuple(g.to(t.dtype) for g, t in zip(outs, (x, dt, a, b, c, d)))


def gated_linear_scan_bwd(
    a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`gated_linear_scan` from its saved output h
    and the cotangent dh: the reverse scan ``g_t = dh_t + a_{t+1} g_{t+1}``
    (a multiply, then an add, as the CUDA kernel rounds), ``db = g`` and
    ``da_t = g_t h_{t-1}`` with h_{-1} = 0; f32 inside, da in a's dtype
    and db in h's (b's)."""
    af, hf, dhf = a.float(), h.float(), dh.float()
    B, S, W = a.shape
    da = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    db = torch.empty_like(da)
    g = torch.zeros((B, W), dtype=torch.float32, device=a.device)
    anext = torch.zeros_like(g)
    zero = torch.zeros_like(g)
    for t in reversed(range(S)):
        g = dhf[:, t] + anext * g
        db[:, t] = g
        da[:, t] = g * (hf[:, t - 1] if t > 0 else zero)
        anext = af[:, t]
    return da.to(a.dtype), db.to(h.dtype)


# --------------------------------------------------------------------------- #
# chunked associative scans (the reference's scan_impl="chunked")
# --------------------------------------------------------------------------- #
def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along axis 1 of the pairs (a, b) under
    ``(al, bl) . (ar, br) = (al * ar, br + ar * bl)``: log2(len) doubling
    steps, each combining every element with the prefix ``d`` before it
    (the identity (1, 0) before the start).  The same function as
    ``lax.associative_scan``, summed in another order."""
    d = 1
    while d < a.shape[1]:
        ap = torch.cat([torch.ones_like(a[:, :d]), a[:, :-d]], dim=1)
        bp = torch.cat([torch.zeros_like(b[:, :d]), b[:, :-d]], dim=1)
        a, b = ap * a, b + a * bp
        d *= 2
    return a, b


def _pad_time(t: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    if not pad:
        return t
    return torch.nn.functional.pad(t, (0, 0, 0, pad), value=value)


def selective_scan_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    d: torch.Tensor,
    chunk: int = 128,
    *,
    final_state: bool = False,
):
    """The mamba-1 scan of :func:`selective_scan` in chunks: an
    associative scan inside each ``chunk`` of steps (the decay factors
    stay in (0, 1], so the product form is safe), the state carried from
    chunk to chunk, so the sequential depth is S / chunk.  With
    ``final_state`` also h_S (B, Di, N) f32, the carried state (padded
    steps have dt 0: decay 1, drive 0)."""
    B, S, Di = x.shape
    chunk = max(1, min(chunk, S))
    pad = (-S) % chunk
    xf = _pad_time(x.float(), pad)
    dtf = _pad_time(dt.float(), pad)
    bf = _pad_time(b.float(), pad)
    cf = _pad_time(c.float(), pad)
    af, df = a.float(), d.float()
    h = torch.zeros((B, Di, a.shape[1]), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, xf.shape[1], chunk):
        xt, dtt = xf[:, c0:c0 + chunk], dtf[:, c0:c0 + chunk]
        bt, ct = bf[:, c0:c0 + chunk], cf[:, c0:c0 + chunk]
        decay = torch.exp(dtt[..., None] * af[None, None])  # (B, c, Di, N)
        drive = (dtt * xt)[..., None] * bt[:, :, None, :]
        A, Bv = _associative_scan(decay, drive)
        hs = A * h[:, None] + Bv
        ys.append((hs * ct[:, :, None, :]).sum(-1) + df[None, None] * xt)
        h = hs[:, -1]
    y = torch.cat(ys, 1)[:, :S].to(x.dtype)
    return (y, h) if final_state else y


def gated_linear_scan_chunked(a: torch.Tensor, b: torch.Tensor,
                              chunk: int = 256) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t of :func:`gated_linear_scan` in chunks (see
    :func:`selective_scan_chunked`); every h_t in b's dtype."""
    B, S, W = a.shape
    chunk = max(1, min(chunk, S))
    pad = (-S) % chunk
    af = _pad_time(a.float(), pad, 1.0)
    bf = _pad_time(b.float(), pad)
    h = torch.zeros((B, W), dtype=torch.float32, device=b.device)
    ys = []
    for c0 in range(0, af.shape[1], chunk):
        A, Bv = _associative_scan(af[:, c0:c0 + chunk], bf[:, c0:c0 + chunk])
        hs = A * h[:, None] + Bv
        ys.append(hs)
        h = hs[:, -1]
    return torch.cat(ys, 1)[:, :S].to(b.dtype)
