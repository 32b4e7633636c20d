"""Layer-program stack of the port: embedding + segments + LM head.

Counterpart of ``repro.models.transformer``.  Each segment's parameters
are stacked on a leading layer axis, as in the reference; where the
reference runs ``lax.scan`` over that axis, the port loops over it in
Python, slicing each layer's parameters and cache as views.  Cache trees
keep the stacked leading axis, so prefill outputs plug straight into
decode inputs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.compat import tree_map
from repro_torch.models import layers as L
from repro_torch.models.common import ArchConfig, Segment, build_layer_program
from repro_torch.parallel.ctx import RunCtx, shard, use_weight

Params = Dict[str, Any]


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #
def block_init(kind: str, cfg: ArchConfig, ctx: RunCtx, gen, lead=()) -> Params:
    if kind != "global":
        raise ValueError(f"block kind {kind!r} is not ported yet")
    return {
        "attn": L.attention_init(cfg, ctx, gen, lead),
        "mlp": L.mlp_init(cfg, ctx, gen, lead=lead),
    }


def block_apply(
    kind: str,
    p: Params,
    cfg: ArchConfig,
    ctx: RunCtx,
    x: torch.Tensor,
    *,
    mode: str,
    cache: Optional[Params],
    cache_len: int,
    positions: torch.Tensor,
    page_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    if kind != "global":
        raise ValueError(f"block kind {kind!r} is not ported yet")
    a, ac = L.apply_attention(
        p["attn"], cfg, ctx, x, positions=positions, mode=mode,
        cache=None if cache is None else cache["attn"],
        cache_len=cache_len, page_table=page_table,
    )
    x = x + a
    x = x + L.apply_mlp(p["mlp"], cfg, x, ctx)
    x = shard(x, ctx)
    return x, {"attn": ac}


# --------------------------------------------------------------------------- #
# stacks (segments)
# --------------------------------------------------------------------------- #
def stack_init(
    kinds: Sequence[str], cfg: ArchConfig, ctx: RunCtx, gen
) -> Tuple[List[Segment], List[Params]]:
    segments = build_layer_program(kinds)
    seg_params: List[Params] = []
    for seg in segments:
        seg_params.append({
            f"b{i}_{kind}": block_init(kind, cfg, ctx, gen, lead=(seg.count,))
            for i, kind in enumerate(seg.unit)
        })
    return segments, seg_params


def stack_apply(
    segments: List[Segment],
    seg_params: List[Params],
    cfg: ArchConfig,
    ctx: RunCtx,
    x: torch.Tensor,
    *,
    mode: str,
    caches: Optional[List[Any]] = None,
    cache_len: int = 0,
    positions: torch.Tensor,
    page_table: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, List[Any]]:
    """``prefill`` builds and returns stacked caches; ``decode`` writes the
    given stacked caches in place (through per-layer views) and returns
    them."""
    if mode not in ("prefill", "decode"):
        raise ValueError(mode)
    new_caches: List[Any] = []
    for si, (seg, sp) in enumerate(zip(segments, seg_params)):
        sc = caches[si] if caches is not None else None
        per_layer = []
        for li in range(seg.count):
            lp = tree_map(lambda t: t[li], sp)
            lc = None if sc is None else tree_map(lambda t: t[li], sc)
            ncs = {}
            for i, kind in enumerate(seg.unit):
                key = f"b{i}_{kind}"
                x, ncs[key] = block_apply(
                    kind, lp[key], cfg, ctx, x, mode=mode,
                    cache=None if lc is None else lc[key],
                    cache_len=cache_len, positions=positions,
                    page_table=page_table,
                )
            per_layer.append(ncs)
        if mode == "prefill":
            new_caches.append(
                tree_map(lambda *ls: torch.stack(ls), *per_layer)
            )
        else:
            new_caches.append(sc)
    return x, new_caches


# --------------------------------------------------------------------------- #
# embedding + head
# --------------------------------------------------------------------------- #
def lm_io_init(cfg: ArchConfig, ctx: RunCtx, gen) -> Params:
    params = {
        "tok": L._normal(gen, (cfg.vocab, cfg.d_model), cfg.dtype, 0.02),
        "norm_f": L.norm_init(cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        params["out"] = L.linear_init(gen, cfg.d_model, (cfg.vocab,), cfg.dtype)
    return params


def embed(io: Params, cfg: ArchConfig, ctx: RunCtx,
          tokens: torch.Tensor) -> torch.Tensor:
    x = io["tok"][tokens.long()]
    return shard(x, ctx)


def _proj_logits(io: Params, cfg: ArchConfig, h: torch.Tensor,
                 ctx: RunCtx) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ use_weight(io["tok"], ctx).T
    return h @ use_weight(io["out"], ctx)


def final_hidden(io: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    return L.apply_norm(io["norm_f"], h)


def logits_fn(io: Params, cfg: ArchConfig, ctx: RunCtx,
              h: torch.Tensor) -> torch.Tensor:
    return _proj_logits(io, cfg, final_hidden(io, cfg, h), ctx)
