"""Model layers of the port (params as plain dicts of tensors).

Counterpart of ``repro.models.layers``: RMS norm and layernorm, RoPE,
GQA self-attention (causal, sliding-window or bidirectional) with its
prefill, dense-decode and paged-decode branches, cross-attention onto
encoder or image embeddings, the gated or plain MLP (SiLU or GELU), the
mixture-of-experts FFN on one device or expert-parallel over the ranks
of a GAS engine, the depthwise causal conv, the mamba-1 mixer and the
RG-LRU mixer.  Parameter trees have the reference's keys and shapes, so
a tree crosses from JAX by value
(``repro_torch.models.build.params_from_jax``).  Beside each ``*_init``
a ``*_specs`` gives the reference's PartitionSpecs of the same tree
(FSDP over ``data``, tensor parallel over ``ctx.tp``), read by the dry
run only; an init given :class:`MetaGenerator` builds the tree on
``meta``, shapes and dtypes without storage.

Decode updates caches IN PLACE (the reference returns new arrays): the
dense cache rows, the page pools and the recurrent states (conv windows,
SSM and RG-LRU states) are written where they lie and the same tensors
are returned.  Callers that need the old cache clone it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.addrspace import PartitionSpec as P
from repro_torch.kernels import ops
from repro_torch.models.common import ArchConfig
from repro_torch.parallel.ctx import RunCtx, use_weight

Params = Dict[str, Any]

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# initializers
# --------------------------------------------------------------------------- #
def _normal(gen: torch.Generator, shape, dtype, scale: float,
            n_lead: int = 0) -> torch.Tensor:
    """Normal draws times ``scale`` in ``dtype``.  A leaf stacked on
    ``n_lead`` leading axes is drawn one trailing block at a time, so
    the f32 draw of a stacked leaf (granite-34b's ``(88, 6144, 24576)``
    ``wi``, kimi-k2's experts) never lies on the device whole."""
    shape = tuple(shape)
    if gen.device.type == "meta":  # abstract init: shapes only
        return torch.empty(shape, dtype=dtype, device=gen.device)
    if n_lead == 0:
        x = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (x * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    for m in out.view((-1,) + shape[n_lead:]):
        m.copy_(_normal(gen, shape[n_lead:], dtype, scale))
    return out


def linear_init(gen, in_dim: int, out_dims, dtype, scale=None, lead=()):
    """``lead`` prepends stacked-layer axes (the reference's vmapped init),
    drawn one layer at a time."""
    out = out_dims if isinstance(out_dims, tuple) else (out_dims,)
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return _normal(gen, tuple(lead) + (in_dim,) + out, dtype, scale,
                   n_lead=len(lead))


def _uniform(gen, shape) -> torch.Tensor:
    """f32 draws uniform in [0, 1) (shapes only on ``meta``)."""
    if gen.device.type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    return torch.rand(tuple(shape), generator=gen, device=gen.device,
                      dtype=torch.float32)


class MetaGenerator:
    """The generator an abstract init takes: it lives on ``meta``, so
    every draw is an unallocated tensor of the right shape and dtype
    (the reference's ``eval_shape`` of ``init``)."""

    device = torch.device("meta")


def norm_init(d: int, device, lead=()) -> Params:
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=torch.float32,
                                device=device)}


def norm_specs() -> Params:
    return {"scale": P(None)}


def apply_norm(p: Params, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMS norm, or layernorm without a bias (the population variance),
    in f32, back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"]
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"]
    else:
        raise ValueError(f"unknown norm {kind!r}")
    return out.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _act(name: str):
    return {"silu": F.silu, "gelu": _gelu}[name]


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (B, S) int32."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device)
        / half
    )
    ang = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #
def attention_init(cfg: ArchConfig, ctx: RunCtx, gen, lead=()) -> Params:
    dh = cfg.resolved_head_dim
    D, H, KH = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    params = {
        "norm": norm_init(D, gen.device, lead),
        "wq": linear_init(gen, D, (H, dh), cfg.dtype, lead=lead),
        "wk": linear_init(gen, D, (KH, dh), cfg.dtype, lead=lead),
        "wv": linear_init(gen, D, (KH, dh), cfg.dtype, lead=lead),
        "wo": linear_init(gen, H * dh, (D,), cfg.dtype, lead=lead),
    }
    if cfg.qk_norm:
        params["q_norm"] = norm_init(dh, gen.device, lead)
        params["k_norm"] = norm_init(dh, gen.device, lead)
    return params


def _kv_spec(cfg: ArchConfig, ctx: RunCtx) -> P:
    """KV projections: heads over tp when divisible, else replicated heads."""
    if ctx.tp_size and cfg.n_kv_heads % ctx.tp_size == 0:
        return P("data", ctx.tp, None)
    return P("data", None, None)


def attention_specs(cfg: ArchConfig, ctx: RunCtx) -> Params:
    """The reference's PartitionSpecs of :func:`attention_init`'s tree."""
    specs = {
        "norm": norm_specs(),
        "wq": P("data", ctx.tp, None),
        "wk": _kv_spec(cfg, ctx),
        "wv": _kv_spec(cfg, ctx),
        "wo": P(ctx.tp, "data"),
    }
    if cfg.qk_norm:
        specs["q_norm"] = norm_specs()
        specs["k_norm"] = norm_specs()
    return specs


def _gqa_scores_softmax_v(q, k, v, mask, scale):
    """q: (B,Sq,H,Dh), k/v: (B,Sk,KH,Dh), mask: (B,Sq,Sk) bool.

    Activations stay in the model dtype and the dots accumulate in f32,
    as the reference's ``preferred_element_type=f32``: the operands are
    widened (exact for bf16) before the f32 product."""
    B, Sq, H, Dh = q.shape
    KH = k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, Dh)
    # the scale in q's dtype, filled on the device (a host tensor copied
    # to the card would make the host wait for the stream)
    qs = qg * torch.full((), scale, dtype=q.dtype, device=q.device)
    s = torch.einsum("bqkgd,bskd->bkgqs", qs.float(), k.float())
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    visible = mask.any(dim=-1)  # (B, Sq)
    o = torch.where(visible[:, :, None, None, None], o, 0.0)
    return o.reshape(B, Sq, H, Dh).to(q.dtype)


def _chunked_attention(q, k, v, qpos, kpos, *, scale, chunk, window=None,
                       causal=True):
    """Blockwise-over-queries attention (O(S·chunk) memory).

    qpos: (B, Sq) absolute query positions; kpos: (B, Sk) key positions
    (-1 = empty cache slot).  ``causal``: a query sees no later key.
    ``window``: a query sees only the keys less than ``window`` positions
    behind it (and, when not causal, ahead of it).
    """
    B, Sq, H, Dh = q.shape
    chunk = min(chunk, Sq)
    pad = (-Sq) % chunk
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        qpos = F.pad(qpos, (0, pad), value=-1)
    outs = []
    for c0 in range(0, q.shape[1], chunk):
        qs = q[:, c0 : c0 + chunk]
        qp = qpos[:, c0 : c0 + chunk]
        mask = kpos[:, None, :] >= 0
        if causal:
            mask = mask & (qp[:, :, None] >= kpos[:, None, :])
        if window is not None:
            mask = mask & ((qp[:, :, None] - kpos[:, None, :]) < window)
            if not causal:
                mask = mask & ((kpos[:, None, :] - qp[:, :, None]) < window)
        mask = mask & (qp[:, :, None] >= 0)
        outs.append(_gqa_scores_softmax_v(qs, k, v, mask, scale))
    return torch.cat(outs, dim=1)[:, :Sq]


def apply_attention(
    p: Params,
    cfg: ArchConfig,
    ctx: RunCtx,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    mode: str = "prefill",
    cache: Optional[Params] = None,
    cache_len: int = 0,
    xkv: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,
    tp=None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Self- or cross-attention sub-block (pre-norm, residual added by
    caller).  ``window`` (the ``local`` kind) limits each query to the
    keys less than ``window`` positions behind it; its cache is a ring of
    ``min(window, cache_len)`` slots.  ``causal=False`` (the ``enc``
    kind) lets every query see every key.

    Modes:
      train    — full sequence, no cache; attention is
                 ``kernels.ops.attention`` (the flash forward and its dK/dV
                 and dQ kernels on the card), differentiable.
      prefill  — full sequence; returns a cache of capacity ``cache_len``.
      decode   — x is (B, 1, D); updates ``cache`` in place.

    Cross-attention (``xkv`` given, (B, S_enc, D)): keys and values are
    ``xkv``'s projections, k-normed but not roped, attended without a
    mask (plain torch, as the reference's ``jnp``); prefill caches them
    ``{k, v, pos}`` at the encoder's length and decode reads that cache.
    ``Model.decode_step`` gives no ``xkv``, as the reference's does, so
    a ``cross``/``xdec`` block decodes its cross sub-block down the self
    path over that cache.

    Paged decode (``page_table`` given, decode mode only): ``cache`` holds
    the layer's slice of the KV *page pool* — ``k``/``v`` shaped
    ``(P, page_tokens, KH, Dh)`` and ``pos`` ``(P, page_tokens)`` — and
    ``page_table`` is ``(B, NP)`` physical ids per request.  The new
    token's K/V scatter straight into the request's (COW-resolved,
    materialised) page and attention runs through the table on
    ``kernels.ops.paged_attention`` — the CUDA kernel on the card.

    Tensor-parallel (``tp`` a :class:`~repro_torch.parallel.tp.TPGroup`):
    the weights and cache hold this rank's heads only, every head-local
    step runs unchanged, and the output projection's partial sum crosses
    the group via ``tp.psum``.
    """
    dh = cfg.resolved_head_dim
    scale = 1.0 / math.sqrt(dh)
    B, S, D = x.shape
    h = apply_norm(p["norm"], x, cfg.norm)
    wq = use_weight(p["wq"], ctx)
    wk = use_weight(p["wk"], ctx)
    wv = use_weight(p["wv"], ctx)
    wo = use_weight(p["wo"], ctx)
    q = torch.einsum("bsd,dhk->bshk", h, wq)
    # qk-norm (always RMS) comes before rope, on q and k alike
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q)

    if xkv is not None:
        if cache is not None and mode == "decode":
            k, v, kpos = cache["k"], cache["v"], cache["pos"]
        else:
            k = torch.einsum("bsd,dhk->bshk", xkv, wk)
            v = torch.einsum("bsd,dhk->bshk", xkv, wv)
            if cfg.qk_norm:
                k = apply_norm(p["k_norm"], k)
            Sk = k.shape[1]
            kpos = torch.arange(Sk, dtype=torch.int32, device=k.device)
            kpos = kpos[None].expand(B, Sk).contiguous()
        if mode == "decode":
            mask = (kpos >= 0)[:, None, :].expand(B, S, kpos.shape[1])
            out = _gqa_scores_softmax_v(q, k, v, mask, scale)
        else:
            out = _chunked_attention(q, k, v, positions, kpos, scale=scale,
                                     chunk=ctx.attn_chunk, causal=False)
        new_cache = ({"k": k, "v": v, "pos": kpos} if mode == "prefill"
                     else cache)
        o = torch.einsum("bshk,hkd->bsd", out, wo.reshape(-1, dh, D))
        if tp is not None:
            o = tp.maybe_psum(o)
        return o.to(x.dtype), new_cache

    k = torch.einsum("bsd,dhk->bshk", h, wk)
    v = torch.einsum("bsd,dhk->bshk", h, wv)
    if cfg.qk_norm:
        k = apply_norm(p["k_norm"], k)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if mode == "train":
        # (B, H, S, Dh), made contiguous for the kernels
        out = ops.attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=causal, window=window,
            scale=scale,
        ).transpose(1, 2)
        new_cache = None
    elif mode == "prefill":
        W = cache_len if window is None else min(window, cache_len)
        # ring-buffer write of the last W positions
        kc = torch.zeros((B, W) + tuple(k.shape[2:]), dtype=k.dtype,
                         device=k.device)
        vc = torch.zeros_like(kc)
        pc = torch.full((B, W), -1, dtype=torch.int32, device=k.device)
        take = min(W, S)
        sl = slice(S - take, S)
        idx = (positions[:, sl] % W).long()  # (B, take)
        b_idx = torch.arange(B, device=k.device)[:, None]
        kc[b_idx, idx] = k[:, sl]
        vc[b_idx, idx] = v[:, sl]
        pc[b_idx, idx] = positions[:, sl].to(torch.int32)
        out = _chunked_attention(
            q, k, v, positions, positions, scale=scale, chunk=ctx.attn_chunk,
            window=window, causal=causal,
        )
        new_cache = {"k": kc, "v": vc, "pos": pc}
    elif mode == "decode" and page_table is not None:
        if window is not None:
            raise ValueError("paged decode does not support local windows")
        kp, vp, pp = cache["k"], cache["v"], cache["pos"]  # page pools
        T = kp.shape[1]  # page_tokens
        pos = positions[:, 0]  # (B,)
        # the write page: COW-resolved and materialised by the host before
        # the step, so live rows never collide.  Dead rows all target the
        # scratch page; a dead row's stale position may run past the table
        # width, and the column clamps as the reference's gather does.
        col = torch.clamp(pos // T, max=page_table.shape[1] - 1).long()
        b_idx = torch.arange(B, device=x.device)
        phys = page_table[b_idx, col].long()
        slot = (pos % T).long()
        kp[phys, slot] = k[:, 0]
        vp[phys, slot] = v[:, 0]
        pp[phys, slot] = pos.to(pp.dtype)
        out = ops.paged_attention(
            q[:, 0], kp, vp, page_table, (pos + 1).to(torch.int32),
            scale=scale,
        )[:, None]
        new_cache = cache
    elif mode == "decode":
        kc, vc, pc = cache["k"], cache["v"], cache["pos"]
        W = kc.shape[1]
        pos = positions[:, 0]  # (B,)
        slot = (pos % W).long()
        b_idx = torch.arange(B, device=x.device)
        kc[b_idx, slot] = k[:, 0]
        vc[b_idx, slot] = v[:, 0]
        pc[b_idx, slot] = pos.to(pc.dtype)
        mask = pc[:, None, :] >= 0  # (B, 1, W)
        mask = mask & (pc[:, None, :] <= pos[:, None, None])
        if window is not None:
            mask = mask & ((pos[:, None, None] - pc[:, None, :]) < window)
        out = _gqa_scores_softmax_v(q, kc, vc, mask, scale)
        new_cache = cache
    else:
        raise ValueError(mode)

    o = torch.einsum("bshk,hkd->bsd", out, wo.reshape(-1, dh, D))
    if tp is not None:
        o = tp.maybe_psum(o)
    return o.to(x.dtype), new_cache


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #
def mlp_init(cfg: ArchConfig, ctx: RunCtx, gen, lead=(),
             d_ff: Optional[int] = None) -> Params:
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    params = {
        "norm": norm_init(D, gen.device, lead),
        "wi": linear_init(gen, D, (Fd,), cfg.dtype, lead=lead),
        "wo": linear_init(gen, Fd, (D,), cfg.dtype, lead=lead),
    }
    if cfg.mlp_gated:
        params["wg"] = linear_init(gen, D, (Fd,), cfg.dtype, lead=lead)
    return params


def mlp_specs(cfg: ArchConfig, ctx: RunCtx) -> Params:
    specs = {
        "norm": norm_specs(),
        "wi": P("data", ctx.tp),
        "wo": P(ctx.tp, "data"),
    }
    if cfg.mlp_gated:
        specs["wg"] = P("data", ctx.tp)
    return specs


def apply_mlp(p: Params, cfg: ArchConfig, x: torch.Tensor,
              ctx: RunCtx, tp=None) -> torch.Tensor:
    """The MLP (pre-norm, residual added by caller): ``act(h wg) * (h
    wi)`` when gated, else ``act(h wi)``, then ``wo``.  Under ``tp`` the
    columns of ``wi``/``wg`` and the rows of ``wo`` are this rank's and
    the partial output is summed over the group."""
    h = apply_norm(p["norm"], x, cfg.norm)
    act = _act(cfg.act)
    wi = use_weight(p["wi"], ctx)
    wo = use_weight(p["wo"], ctx)
    if cfg.mlp_gated:
        z = act(h @ use_weight(p["wg"], ctx)) * (h @ wi)
    else:
        z = act(h @ wi)
    y = z @ wo
    if tp is not None:
        y = tp.maybe_psum(y)
    return y.to(x.dtype)


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #
def moe_init(cfg: ArchConfig, ctx: RunCtx, gen, lead=()) -> Params:
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = tuple(lead)
    n = len(lead) + 1  # one expert matrix at a time
    params = {
        "norm": norm_init(D, gen.device, lead),
        "router": linear_init(gen, D, (E,), torch.float32, lead=lead),
        "wi": _normal(gen, lead + (E, D, Fd), cfg.dtype, 1.0 / math.sqrt(D),
                      n_lead=n),
        "wg": _normal(gen, lead + (E, D, Fd), cfg.dtype, 1.0 / math.sqrt(D),
                      n_lead=n),
        "wo": _normal(gen, lead + (E, Fd, D), cfg.dtype,
                      1.0 / math.sqrt(Fd), n_lead=n),
    }
    if cfg.n_shared_experts:
        params["shared"] = mlp_init(cfg, ctx, gen, lead,
                                    d_ff=cfg.d_ff * cfg.n_shared_experts)
    if cfg.moe_dense_residual:
        params["dense_res"] = mlp_init(cfg, ctx, gen, lead,
                                       d_ff=cfg.resolved_d_ff_dense)
    return params


def moe_specs(cfg: ArchConfig, ctx: RunCtx) -> Params:
    """Experts over tp, their input dim over data (FSDP)."""
    specs = {
        "norm": norm_specs(),
        "router": P("data", None),
        "wi": P(ctx.tp, "data", None),
        "wg": P(ctx.tp, "data", None),
        "wo": P(ctx.tp, None, "data"),
    }
    if cfg.n_shared_experts:
        specs["shared"] = mlp_specs(cfg, ctx)
    if cfg.moe_dense_residual:
        specs["dense_res"] = mlp_specs(cfg, ctx)
    return specs


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for one call of ``n_tokens`` tokens (the
    reference's ``max(4, ceil(B S K cf / E))``): a token's output depends
    on the other tokens of the same call."""
    return max(4, int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                                / cfg.n_experts)))


def _moe_local(p: Params, cfg: ArchConfig, ctx: RunCtx, x2d: torch.Tensor,
               capacity: int) -> torch.Tensor:
    """Single-device MoE: the router (the CUDA kernel on the card), the
    dense dispatch into (E, C, D) buffers, the experts' products as
    batched matrix products, the weighted combine."""
    logits = x2d.float() @ p["router"]
    e, s, w, keep = ops.moe_router(logits, k=cfg.top_k, capacity=capacity)
    buf = ops.moe_dispatch(x2d, e, s, keep, n_experts=cfg.n_experts,
                           capacity=capacity)
    hidden = _act(cfg.act)(torch.bmm(buf, p["wg"])) * torch.bmm(buf, p["wi"])
    out_buf = torch.bmm(hidden, p["wo"])
    return ops.moe_combine(out_buf, e, s, w, keep).to(x2d.dtype)


def _moe_ep(p: Params, cfg: ArchConfig, ctx: RunCtx,
            x2d: torch.Tensor) -> torch.Tensor:
    """Expert-parallel MoE: Active-Message-style dispatch and an
    all-to-all over the model ranks of ``ctx.ep_grid`` (data, model).

    Tokens are sharded over data x model when they divide, else over data
    alone (every model rank then routes the same tokens); experts over
    model, each rank's ``(E/model, D, F)`` a view of the stacked weights.
    Inside one ``Context.spmd`` over the model ranks (engine
    ``ctx.moe_backend``; on "gascore" the all-to-all rides the
    ``ring_shift`` kernel), each rank routes each of its data shards'
    tokens into per-expert capacity buffers of ``C_l`` slots (the router
    kernel once a rank and shard on the card), one all-to-all carries
    every shard's buffers to the experts' home ranks, the experts compute
    there and the rows travel back the same way to be combined.  The
    data shards are independent groups (the reference's shard_map over
    the data axis); here they share the exchange's launches."""
    from repro_torch.core import gasnet
    from repro_torch.core.addrspace import P

    dp, tp = ctx.ep_grid
    E, K = cfg.n_experts, cfg.top_k
    T, D = x2d.shape
    if E % tp or T % dp:
        raise ValueError(f"EP over {ctx.ep_grid}: {E} experts, {T} tokens")
    E_l = E // tp
    by_model = T % (dp * tp) == 0
    T_l = T // (dp * tp if by_model else dp)
    C_l = max(4, int(math.ceil(T_l * K * cfg.capacity_factor / E)))
    act = _act(cfg.act)

    def body(node, xs, router_w, wi, wg, wo):
        # xs: (dp, T_l, D), this rank's tokens of every data shard
        eng = node.engine
        routes = [ops.moe_router(x.float() @ router_w, k=K, capacity=C_l)
                  for x in xs.unbind(0)]
        buf = torch.stack([
            ops.moe_dispatch(x, e, s, keep, n_experts=E, capacity=C_l)
            for x, (e, s, _, keep) in zip(xs.unbind(0), routes)])
        # home-major (tp, dp, E_l, C_l, D): each home's rows in one block
        send = buf.reshape(dp, tp, E_l, C_l, D).transpose(0, 1)
        recv = eng.all_to_all(send.reshape(tp * dp * E_l * C_l, D))
        rows = recv.reshape(tp * dp, E_l, C_l, D).transpose(0, 1)
        rows = rows.reshape(E_l, tp * dp * C_l, D)
        hid = act(torch.bmm(rows, wg)) * torch.bmm(rows, wi)
        out_rows = torch.bmm(hid, wo)
        back = out_rows.reshape(E_l, tp * dp, C_l, D).transpose(0, 1)
        back = eng.all_to_all(back.reshape(tp * dp * E_l * C_l, D))
        back = back.reshape(tp, dp, E_l, C_l, D).transpose(0, 1)
        back = back.reshape(dp, E, C_l, D)
        return torch.stack([
            ops.moe_combine(back[d], e, s, w, keep)
            for d, (e, s, w, keep) in enumerate(routes)]).to(xs.dtype)

    ectx = gasnet.Context(tp, node_axis="model", backend=ctx.moe_backend,
                          device=x2d.device)
    spec = P("model")
    if by_model:  # token (d, r, t) at ((d tp + r) T_l + t), the reference's
        xs = x2d.reshape(dp, tp, T_l, D).transpose(0, 1).reshape(
            tp * dp, T_l, D)
        y = ectx.spmd(body, xs, p["router"], p["wi"], p["wg"], p["wo"],
                      in_specs=(spec, P(), spec, spec, spec), out_specs=spec)
        return y.reshape(tp, dp, T_l, D).transpose(0, 1).reshape(T, D)
    y = ectx.spmd(body, x2d.reshape(dp, T_l, D), p["router"], p["wi"],
                  p["wg"], p["wo"], in_specs=(P(), P(), spec, spec, spec),
                  out_specs=P())
    return y.reshape(T, D)


def use_ep(cfg: ArchConfig, ctx: RunCtx, n_tokens: int) -> bool:
    """The reference's choice of MoE path: "ep_shardmap" always; "auto"
    when the grid has model ranks, they divide the experts and the data
    ranks divide the tokens."""
    dp, tp = ctx.ep_grid
    return ctx.moe_mode == "ep_shardmap" or (
        ctx.moe_mode == "auto" and tp > 1 and cfg.n_experts % tp == 0
        and n_tokens % dp == 0)


def apply_moe(p: Params, cfg: ArchConfig, ctx: RunCtx,
              x: torch.Tensor) -> torch.Tensor:
    """The MoE FFN of a ``moe`` block (pre-norm, residual added by the
    caller), expert-parallel or local by :func:`use_ep`, plus the shared
    expert (kimi) or the dense residual FFN (arctic), each with its own
    norm."""
    B, S, D = x.shape
    h = apply_norm(p["norm"], x, cfg.norm)
    if use_ep(cfg, ctx, B * S):
        y = _moe_ep(p, cfg, ctx, h.reshape(B * S, D)).reshape(B, S, D)
    else:
        y = _moe_local(p, cfg, ctx, h.reshape(B * S, D),
                       moe_capacity(cfg, B * S)).reshape(B, S, D)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], cfg, x, ctx)
    if "dense_res" in p:
        y = y + apply_mlp(p["dense_res"], cfg, x, ctx)
    return y.to(x.dtype)


# --------------------------------------------------------------------------- #
# causal conv (width w, depthwise)
# --------------------------------------------------------------------------- #
def causal_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B, S, C), w: (W, C).

    With ``state`` (B, W-1, C): uses it as left context (decode);
    returns ``(y, new_state)``, new_state the last W-1 inputs (a view).
    Sums the taps in the reference's order, in x's dtype."""
    W = w.shape[0]
    S = x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(W))
    if b is not None:
        y = y + b[None, None, :]
    new_state = xp[:, -(W - 1):] if W > 1 else torch.zeros_like(x[:, :0])
    return y.to(x.dtype), new_state


def _write_state(cache: Params, new: Params) -> Params:
    """Decode: copy each new recurrent state into the cache's tensor (a
    view into the stacked cache), in place."""
    for k, t in new.items():
        cache[k].copy_(t)
    return cache


# --------------------------------------------------------------------------- #
# mamba1 mixer
# --------------------------------------------------------------------------- #
def mamba_init(cfg: ArchConfig, ctx: RunCtx, gen, lead=()) -> Params:
    D, Di, N = cfg.d_model, cfg.resolved_d_inner, cfg.ssm_state
    R, Wc = cfg.resolved_dt_rank, cfg.conv_width
    dev, lead = gen.device, tuple(lead)
    f32 = torch.float32
    # dt_bias = softplus^-1(dt) for dt log-uniform in [1e-3, 1e-1]
    u = _uniform(gen, lead + (Di,))
    log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
    a_log = torch.log(torch.arange(1, N + 1, dtype=f32, device=dev))
    return {
        "norm": norm_init(D, dev, lead),
        "in_x": linear_init(gen, D, (Di,), cfg.dtype, lead=lead),
        "in_gate": linear_init(gen, D, (Di,), cfg.dtype, lead=lead),
        "conv_w": _normal(gen, lead + (Wc, Di), cfg.dtype, 1.0 / math.sqrt(Wc),
                          n_lead=len(lead)),
        "conv_b": torch.zeros(lead + (Di,), dtype=cfg.dtype, device=dev),
        "x_proj": linear_init(gen, Di, (R + 2 * N,), cfg.dtype, lead=lead),
        "dt_proj": linear_init(gen, R, (Di,), cfg.dtype, lead=lead),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "a_log": a_log.expand(lead + (Di, N)).contiguous(),
        "d_skip": torch.ones(lead + (Di,), dtype=f32, device=dev),
        "out_proj": linear_init(gen, Di, (D,), cfg.dtype, lead=lead),
    }


def mamba_specs(cfg: ArchConfig, ctx: RunCtx) -> Params:
    return {
        "norm": norm_specs(),
        "in_x": P("data", ctx.tp),
        "in_gate": P("data", ctx.tp),
        "conv_w": P(None, ctx.tp),
        "conv_b": P(ctx.tp),
        "x_proj": P(ctx.tp, None),
        "dt_proj": P(None, ctx.tp),
        "dt_bias": P(ctx.tp),
        "a_log": P(ctx.tp, None),
        "d_skip": P(ctx.tp),
        "out_proj": P(ctx.tp, "data"),
    }


def apply_mamba(
    p: Params,
    cfg: ArchConfig,
    ctx: RunCtx,
    x: torch.Tensor,
    *,
    mode: str = "train",
    cache: Optional[Params] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Mamba-1 mixer (pre-norm, residual added by caller).

    train/prefill run the selective scan (``kernels.ops.selective_scan``:
    the CUDA kernel on the card, which also returns the final state the
    prefill caches); decode is the one-step closed form in plain torch,
    writing the conv window and the SSM state in place."""
    N, R = cfg.ssm_state, cfg.resolved_dt_rank
    h = apply_norm(p["norm"], x, cfg.norm)
    xin = h @ use_weight(p["in_x"], ctx)  # (B, S, Di)
    gate = h @ use_weight(p["in_gate"], ctx)
    w_out = use_weight(p["out_proj"], ctx)

    conv_state = cache["conv"] if cache is not None else None
    xin, new_conv = causal_conv(xin, p["conv_w"], p["conv_b"], conv_state)
    xin = F.silu(xin)

    dbc = xin @ p["x_proj"]  # (B, S, R + 2N)
    dt_low, bmat, cmat = dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:]
    # bf16 @ bf16 + f32 bias promotes to f32, as in the reference
    dt = F.softplus(dt_low @ p["dt_proj"] + p["dt_bias"]).float()
    a = -torch.exp(p["a_log"])  # (Di, N)

    if mode == "decode":
        hprev = cache["ssm"]  # (B, Di, N) f32
        dtt = dt[:, 0]
        xt = xin[:, 0].float()
        bt = bmat[:, 0].float()
        ct = cmat[:, 0].float()
        decay = torch.exp(dtt[..., None] * a[None])
        hnew = decay * hprev + (dtt * xt)[..., None] * bt[:, None, :]
        y = (hnew * ct[:, None, :]).sum(-1) + p["d_skip"][None] * xt
        y = y[:, None, :]
        new_cache = _write_state(cache, {"conv": new_conv, "ssm": hnew})
    elif mode == "prefill":
        y, hfin = ops.selective_scan(
            xin, dt, a, bmat, cmat, p["d_skip"], final_state=True,
            impl=ctx.scan_impl,
        )
        new_cache = {"conv": new_conv, "ssm": hfin}
    elif mode == "train":
        y = ops.selective_scan(xin, dt, a, bmat, cmat, p["d_skip"],
                               impl=ctx.scan_impl)
        new_cache = None
    else:
        raise ValueError(mode)

    y = (y * F.silu(gate.float())).to(x.dtype)
    out = y @ w_out
    return out.to(x.dtype), new_cache


# --------------------------------------------------------------------------- #
# RG-LRU mixer (griffin / recurrentgemma)
# --------------------------------------------------------------------------- #
_RGLRU_C = 8.0


def rec_init(cfg: ArchConfig, ctx: RunCtx, gen, lead=()) -> Params:
    D, W, Wc = cfg.d_model, cfg.resolved_lru_width, cfg.conv_width
    dev, lead = gen.device, tuple(lead)
    lam = _uniform(gen, lead + (W,))
    return {
        "norm": norm_init(D, dev, lead),
        "in_x": linear_init(gen, D, (W,), cfg.dtype, lead=lead),
        "in_gate": linear_init(gen, D, (W,), cfg.dtype, lead=lead),
        "conv_w": _normal(gen, lead + (Wc, W), cfg.dtype, 1.0 / math.sqrt(Wc),
                          n_lead=len(lead)),
        "conv_b": torch.zeros(lead + (W,), dtype=cfg.dtype, device=dev),
        "w_rgate": linear_init(gen, W, (W,), cfg.dtype, lead=lead),
        "w_igate": linear_init(gen, W, (W,), cfg.dtype, lead=lead),
        "lam": 0.5 + 3.5 * lam,  # uniform in [0.5, 4)
        "out_proj": linear_init(gen, W, (D,), cfg.dtype, lead=lead),
    }


def rec_specs(cfg: ArchConfig, ctx: RunCtx) -> Params:
    return {
        "norm": norm_specs(),
        "in_x": P("data", ctx.tp),
        "in_gate": P("data", ctx.tp),
        "conv_w": P(None, ctx.tp),
        "conv_b": P(ctx.tp),
        "w_rgate": P("data", ctx.tp),
        "w_igate": P("data", ctx.tp),
        "lam": P(ctx.tp),
        "out_proj": P(ctx.tp, "data"),
    }


def apply_rec(
    p: Params,
    cfg: ArchConfig,
    ctx: RunCtx,
    x: torch.Tensor,
    *,
    mode: str = "train",
    cache: Optional[Params] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """RG-LRU mixer (pre-norm, residual added by caller).

    train/prefill run the gated linear scan (``kernels.ops.
    gated_linear_scan``: the CUDA kernel on the card); decode is the
    one-step update in plain torch, writing the conv window and the state
    in place."""
    h = apply_norm(p["norm"], x, cfg.norm)
    w_rg = use_weight(p["w_rgate"], ctx)
    w_ig = use_weight(p["w_igate"], ctx)
    xb = h @ use_weight(p["in_x"], ctx)  # (B, S, W)
    gb = _gelu((h @ use_weight(p["in_gate"], ctx)).float())

    conv_state = cache["conv"] if cache is not None else None
    xb, new_conv = causal_conv(xb, p["conv_w"], p["conv_b"], conv_state)

    xf = xb.float()
    r = torch.sigmoid(xf @ w_rg.float())
    i = torch.sigmoid(xf @ w_ig.float())
    log_a = -_RGLRU_C * F.softplus(p["lam"])[None, None] * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * xf)

    if mode == "decode":
        hnew = a[:, 0] * cache["h"] + b[:, 0]  # (B, W) f32
        y = hnew[:, None, :]
        new_cache = _write_state(cache, {"conv": new_conv, "h": hnew})
    elif mode in ("prefill", "train"):
        y = ops.gated_linear_scan(a, b, impl=ctx.scan_impl)
        new_cache = ({"conv": new_conv, "h": y[:, -1, :].float()}
                     if mode == "prefill" else None)
    else:
        raise ValueError(mode)

    out = (y * gb).to(x.dtype) @ use_weight(p["out_proj"], ctx)
    return out.to(x.dtype), new_cache
