"""Layer-program stack of the port: embedding + segments + LM head.

Counterpart of ``repro.models.transformer``.  Each segment's parameters
are stacked on a leading layer axis, as in the reference; where the
reference runs ``lax.scan`` over that axis, the port loops over it in
Python, slicing each layer's parameters and cache as views.  Cache trees
keep the stacked leading axis, so prefill outputs plug straight into
decode inputs.  Training takes each segment's layers apart once with
``torch.unbind``, so the backward stacks each leaf's per-layer gradients
once (a ``t[li]`` per layer would add a zero tensor of the whole stacked
leaf for every layer), and recomputes each layer under
``torch.utils.checkpoint`` when ``ctx.remat`` is not "none": "full"
keeps only the layer's input, "dots" and "names" are the reference's two
checkpoint policies as selective checkpointing
(``create_selective_checkpoint_contexts``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from repro_torch.compat import tree_leaves, tree_map, tree_unflatten
from repro_torch.models import layers as L
from repro_torch.models.common import ArchConfig, Segment, build_layer_program
from repro_torch.parallel.ctx import RunCtx, shard, use_weight

Params = Dict[str, Any]


# --------------------------------------------------------------------------- #
# checkpoint names (the reference's ``checkpoint_name``)
# --------------------------------------------------------------------------- #
SAVED_NAMES = ("attn_out", "mlp_out", "moe_out", "mix_out")


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Identity that marks a sub-block's output: remat "names" saves the
    outputs of this op and recomputes the rest."""
    return x.clone()


_checkpoint_name.register_autograd(lambda ctx, g: (g, None))


def checkpoint_name(x: torch.Tensor, name: str, ctx: RunCtx,
                    mode: str) -> torch.Tensor:
    """``x`` tagged with ``name`` where remat "names" will read the tag
    (training); ``x`` itself everywhere else."""
    if mode != "train" or ctx.remat != "names":
        return x
    return _checkpoint_name(x, name)


# matrix products without batch dims (``x @ W``: 2-D after matmul folds
# the leading dims); bmm and the attention kernels have batch dims
_NO_BATCH_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``."""
    return (CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_names(ctx, op, *args, **kwargs):
    """``save_only_these_names(*SAVED_NAMES)``: every tag block_apply sets
    is one of them."""
    return (CheckpointPolicy.MUST_SAVE
            if op is torch.ops.repro_torch.checkpoint_name.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


_POLICIES = {"dots": _save_dots, "names": _save_names}


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #
def block_init(kind: str, cfg: ArchConfig, ctx: RunCtx, gen, lead=()) -> Params:
    if kind in ("global", "local", "dense", "enc"):
        d_ff = cfg.resolved_d_ff_dense if kind == "dense" else cfg.d_ff
        return {
            "attn": L.attention_init(cfg, ctx, gen, lead),
            "mlp": L.mlp_init(cfg, ctx, gen, lead=lead, d_ff=d_ff),
        }
    if kind == "moe":
        return {
            "attn": L.attention_init(cfg, ctx, gen, lead),
            "moe": L.moe_init(cfg, ctx, gen, lead),
        }
    if kind == "mamba":
        return {"mix": L.mamba_init(cfg, ctx, gen, lead)}
    if kind == "rec":
        return {
            "mix": L.rec_init(cfg, ctx, gen, lead),
            "mlp": L.mlp_init(cfg, ctx, gen, lead=lead),
        }
    if kind in ("cross", "xdec"):
        params = {
            "attn": L.attention_init(cfg, ctx, gen, lead),
            "xattn": L.attention_init(cfg, ctx, gen, lead),
            "mlp": L.mlp_init(cfg, ctx, gen, lead=lead),
        }
        if kind == "cross":  # tanh(0): the image path starts closed
            params["xgate"] = torch.zeros(tuple(lead), dtype=torch.float32,
                                          device=gen.device)
        return params
    raise ValueError(kind)


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
    xkv: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,
    tp=None,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """One block.  ``enc`` is a ``global`` block without the causal
    mask; ``cross`` (gated by ``tanh(xgate)``) and ``xdec`` add a
    cross-attention onto ``xkv`` between the self-attention and the MLP,
    their sub-blocks untagged as in the reference."""
    get = (lambda k: None) if cache is None else cache.get
    if kind in ("global", "local", "dense", "enc", "moe"):
        a, ac = L.apply_attention(
            p["attn"], cfg, ctx, x, positions=positions,
            causal=kind != "enc",
            window=cfg.local_window if kind == "local" else None, mode=mode,
            cache=get("attn"), cache_len=cache_len, page_table=page_table,
            tp=tp,
        )
        x = x + checkpoint_name(a, "attn_out", ctx, mode)
        if kind == "moe":
            x = x + checkpoint_name(L.apply_moe(p["moe"], cfg, ctx, x),
                                    "moe_out", ctx, mode)
        else:
            x = x + checkpoint_name(L.apply_mlp(p["mlp"], cfg, x, ctx, tp=tp),
                                    "mlp_out", ctx, mode)
        new_cache = {"attn": ac}
    elif kind in ("mamba", "rec"):
        if page_table is not None:
            raise ValueError(f"paged decode unsupported for {kind!r} blocks")
        apply = L.apply_mamba if kind == "mamba" else L.apply_rec
        m, mc = apply(p["mix"], cfg, ctx, x, mode=mode, cache=get("mix"))
        x = x + checkpoint_name(m, "mix_out", ctx, mode)
        if kind == "rec":
            x = x + checkpoint_name(L.apply_mlp(p["mlp"], cfg, x, ctx, tp=tp),
                                    "mlp_out", ctx, mode)
        new_cache = {"mix": mc}
    elif kind in ("cross", "xdec"):
        if page_table is not None:
            raise ValueError(f"paged decode unsupported for {kind!r} blocks")
        a, ac = L.apply_attention(
            p["attn"], cfg, ctx, x, positions=positions, mode=mode,
            cache=get("attn"), cache_len=cache_len, tp=tp,
        )
        x = x + a
        c, cc = L.apply_attention(
            p["xattn"], cfg, ctx, x, positions=positions, mode=mode,
            cache=get("xattn"), cache_len=cache_len, xkv=xkv, tp=tp,
        )
        if kind == "cross":
            c = torch.tanh(p["xgate"]).to(c.dtype) * c
        x = x + c
        x = x + L.apply_mlp(p["mlp"], cfg, x, ctx, tp=tp)
        new_cache = {"attn": ac, "xattn": cc}
    else:
        raise ValueError(kind)
    x = shard(x, ctx)
    return x, new_cache


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


def _maybe_remat(fn: Callable, ctx: RunCtx) -> Callable:
    """``remat="full"``: keep only the layer's input and recompute its
    forward in the backward (the reference's ``jax.checkpoint``); "dots"
    and "names" save what their policy names and recompute the rest."""
    if ctx.remat == "none":
        return fn
    kw = {}
    if ctx.remat in _POLICIES:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _POLICIES[ctx.remat])

    def remat(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return remat


def _unbind_layers(sp: Params, count: int) -> List[Params]:
    """A stacked segment tree as ``count`` per-layer trees of views, taken
    apart by one ``torch.unbind`` per leaf."""
    parts = [t.unbind(0) for t in tree_leaves(sp)]
    return [tree_unflatten(sp, [p[li] for p in parts]) for li in range(count)]


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
    xkv: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,
    tp=None,
) -> Tuple[torch.Tensor, List[Any]]:
    """``train`` returns ``(x, None)``, differentiable in ``x``, ``xkv``
    and the parameters; ``prefill`` builds and returns stacked caches;
    ``decode`` writes the given stacked caches in place (through
    per-layer views) and returns them.  ``xkv`` (encoder or image
    embeddings) feeds the ``cross``/``xdec`` blocks' cross-attention.
    ``tp`` (a ``TPGroup``) runs every block on this rank's shard, its
    sub-blocks' partial sums crossing the group."""
    if mode == "train":
        for seg, sp in zip(segments, seg_params):

            def unit_body(xc, lp, xkv_, seg=seg):
                for i, kind in enumerate(seg.unit):
                    xc, _ = block_apply(
                        kind, lp[f"b{i}_{kind}"], cfg, ctx, xc, mode=mode,
                        cache=None, cache_len=0, positions=positions,
                        xkv=xkv_,
                    )
                return xc

            body = _maybe_remat(unit_body, ctx)
            for lp in _unbind_layers(sp, seg.count):
                x = body(x, lp, xkv)
        return x, None
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
                    cache_len=cache_len, positions=positions, xkv=xkv,
                    page_table=page_table, tp=tp,
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
    # F.embedding: its backward on the CPU sums in a fixed order, where
    # indexing accumulates with atomics (restart must be bit-exact)
    x = F.embedding(tokens.long(), io["tok"])
    return shard(x, ctx)


def _proj_logits(io: Params, cfg: ArchConfig, h: torch.Tensor,
                 ctx: RunCtx) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ use_weight(io["tok"], ctx).T
    return h @ use_weight(io["out"], ctx)


def final_hidden(io: Params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    return L.apply_norm(io["norm_f"], h, cfg.norm)


def logits_fn(io: Params, cfg: ArchConfig, ctx: RunCtx,
              h: torch.Tensor) -> torch.Tensor:
    return _proj_logits(io, cfg, final_hidden(io, cfg, h), ctx)


def chunked_ce_loss(
    io: Params,
    cfg: ArchConfig,
    ctx: RunCtx,
    h: torch.Tensor,
    targets: torch.Tensor,
    mask: torch.Tensor,
    chunk: int = 512,
) -> torch.Tensor:
    """Cross-entropy without the full (B, S, V) logits at once: each
    ``chunk`` of positions projects to the vocabulary in f32, reduces to
    its summed NLL and is dropped; the result is the mask-weighted mean.
    Under autograd each chunk keeps its f32 logits for the backward."""
    S = h.shape[1]
    h = final_hidden(io, cfg, h)
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], chunk):
        logits = _proj_logits(io, cfg, h[:, c0:c0 + chunk], ctx).float()
        lse = torch.logsumexp(logits, dim=-1)
        ts = targets[:, c0:c0 + chunk].long()
        tgt = torch.gather(logits, -1, ts[..., None])[..., 0]
        ms = mask[:, c0:c0 + chunk]
        tot = tot + ((lse - tgt) * ms).sum()
        cnt = cnt + ms.sum()
    return tot / torch.clamp(cnt, min=1.0)
