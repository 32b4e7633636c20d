"""Model facade of the port: init / train / prefill / decode, and the
spec half the dry run reads.

Counterpart of ``repro.models.build``.  Parameters are plain nested dicts
of tensors with the reference's key paths and stacked ``(L, ...)``
leaves; :func:`params_from_jax` carries a reference tree across by value.
The dry run's stand-ins are the reference's with ``meta`` in place of
``eval_shape``: :meth:`Model.abstract_init` builds the parameter tree on
``meta`` beside its PartitionSpecs, :meth:`Model.input_structs` and
:meth:`Model.cache_structs` give ``TensorSpec`` trees (the cache's from a
prefill run on ``meta``), and ``input_specs`` / ``cache_specs`` their
specs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.compat import (TensorSpec, resolve_device,
                                tree_flatten_with_path, tree_map,
                                tree_unflatten)
from repro_torch.configs.registry import ShapeConfig
from repro_torch.core.addrspace import PartitionSpec as P
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.common import ArchConfig, Segment, build_layer_program
from repro_torch.parallel.ctx import RunCtx

__all__ = ["Model", "build_model", "ctx_local", "meta_tensors",
           "params_from_jax", "structs_of"]

PROMPT_STRUCT = 128  # the prompt of cache_structs' prefill on meta


@dataclasses.dataclass
class Model:
    """All entry points close over (cfg, segment structure); params are
    explicit trees so the caller controls placement."""

    cfg: ArchConfig
    dec_segments: List[Segment]
    enc_segments: Optional[List[Segment]] = None

    # ------------------------------------------------------------------ #
    def init(self, ctx: RunCtx, generator: torch.Generator,
             device: Any = None) -> Dict:
        """Random parameters drawn from ``generator``, which must live on
        ``device`` (CUDA unless the caller asks for another device).  An
        encoder-decoder arch has an ``"enc"`` stack beside ``"dec"``."""
        dev = resolve_device(device)
        if generator.device.type != dev.type:
            raise ValueError(
                f"generator on {generator.device}, parameters on {dev}"
            )
        cfg = self.cfg
        params = {"io": T.lm_io_init(cfg, ctx, generator)}
        _, params["dec"] = T.stack_init(cfg.layer_kinds(), cfg, ctx, generator)
        if cfg.n_enc_layers:
            _, params["enc"] = T.stack_init(["enc"] * cfg.n_enc_layers, cfg,
                                            ctx, generator)
        return params

    def abstract_init(self, ctx: RunCtx) -> Tuple[Dict, Dict]:
        """(parameter tree on ``meta``, PartitionSpecs leaf for leaf) with
        no allocation and no generator: how the dry run stands up a
        1T-parameter model on any host."""
        cfg = self.cfg
        specs = {"io": T.lm_io_specs(cfg, ctx),
                 "dec": T.stack_specs(cfg.layer_kinds(), cfg, ctx)}
        if cfg.n_enc_layers:
            specs["enc"] = T.stack_specs(["enc"] * cfg.n_enc_layers, cfg, ctx)
        return self.init(ctx, L.MetaGenerator(), device="meta"), specs

    # ------------------------------------------------------------------ #
    def _encode(self, params, ctx: RunCtx, frames: torch.Tensor) -> torch.Tensor:
        """The encoder stack (bidirectional, mode "train") over the frame
        embeddings, then the decoder's final norm, as the reference."""
        B, S, _ = frames.shape
        pos = torch.arange(S, dtype=torch.int32, device=frames.device)
        x, _ = T.stack_apply(
            self.enc_segments, params["enc"], self.cfg, ctx,
            frames.to(self.cfg.dtype), mode="train",
            positions=pos[None].expand(B, S),
        )
        return T.final_hidden(params["io"], self.cfg, x)

    def _xkv(self, params, ctx: RunCtx, batch: Dict) -> Optional[torch.Tensor]:
        """What the cross-attention reads: the encoded ``frames`` of an
        encoder-decoder, else the given ``xkv`` embeddings, else None."""
        if self.cfg.n_enc_layers:
            return self._encode(params, ctx, batch["frames"])
        if "xkv" in batch:
            return batch["xkv"].to(self.cfg.dtype)
        return None

    # ------------------------------------------------------------------ #
    def train_hidden(self, params, ctx: RunCtx, batch: Dict) -> torch.Tensor:
        """The decoder stack's output over the whole batch, differentiable
        in ``params``."""
        cfg = self.cfg
        tokens = batch["inputs"]
        B, S = tokens.shape
        pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
        pos = pos[None].expand(B, S)
        x = T.embed(params["io"], cfg, ctx, tokens)
        x, _ = T.stack_apply(
            self.dec_segments, params["dec"], cfg, ctx, x,
            mode="train", positions=pos, xkv=self._xkv(params, ctx, batch),
        )
        return x

    def train_loss(self, params, ctx: RunCtx, batch: Dict) -> torch.Tensor:
        h = self.train_hidden(params, ctx, batch)
        return T.chunked_ce_loss(
            params["io"], self.cfg, ctx, h, batch["targets"], batch["mask"]
        )

    def train_logits(self, params, ctx: RunCtx, batch: Dict) -> torch.Tensor:
        """Full logits (small configs / tests only)."""
        h = self.train_hidden(params, ctx, batch)
        return T.logits_fn(params["io"], self.cfg, ctx, h)

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def prefill(
        self, params, ctx: RunCtx, batch: Dict, cache_len: int
    ) -> Tuple[torch.Tensor, Any]:
        cfg = self.cfg
        tokens = batch["inputs"]
        B, S = tokens.shape
        pos = torch.arange(S, dtype=torch.int32, device=tokens.device)
        pos = pos[None].expand(B, S)
        x = T.embed(params["io"], cfg, ctx, tokens)
        x, caches = T.stack_apply(
            self.dec_segments, params["dec"], cfg, ctx, x,
            mode="prefill", cache_len=cache_len, positions=pos,
            xkv=self._xkv(params, ctx, batch),
        )
        logits = T.logits_fn(params["io"], cfg, ctx, x[:, -1:, :])[:, 0]
        return logits, caches

    @torch.no_grad()
    def decode_step(
        self,
        params,
        ctx: RunCtx,
        token: torch.Tensor,  # (B, 1) int32
        positions: torch.Tensor,  # (B,) int32 — index of the new token
        caches: Any,
    ) -> Tuple[torch.Tensor, Any]:
        """One token for every row; ``caches`` are written in place.  No
        ``xkv``, as in the reference: a ``cross``/``xdec`` block's cross
        sub-block decodes down the self path over its prefill cache."""
        cfg = self.cfg
        pos = positions[:, None]
        x = T.embed(params["io"], cfg, ctx, token)
        x, caches = T.stack_apply(
            self.dec_segments, params["dec"], cfg, ctx, x,
            mode="decode", caches=caches, positions=pos,
        )
        logits = T.logits_fn(params["io"], cfg, ctx, x)[:, 0]
        return logits, caches

    @torch.no_grad()
    def decode_step_paged(
        self,
        params,
        ctx: RunCtx,
        token: torch.Tensor,  # (B, 1) int32
        positions: torch.Tensor,  # (B,) int32 — index of the new token
        pool_caches: Any,
        page_table: torch.Tensor,  # (B, NP) int32 physical page ids
        tp=None,
    ) -> Tuple[torch.Tensor, Any]:
        """Decode one token for every request THROUGH the page table.

        ``pool_caches`` is the cache tree with every leaf's token axis
        re-laid as ``(physical pages, page_tokens)`` — the
        ``PagedLayout.decode_views`` of the pool, shared by the whole
        batch.  The new token's K/V scatter straight into the pool (in
        place) and attention runs on the paged-attention kernel.

        ``tp`` (a :class:`~repro_torch.parallel.tp.TPGroup`) runs this
        rank's head shard: ``params`` and ``pool_caches`` hold only this
        rank's heads (``tp.shard_decode_params`` /
        ``PagedLayout.shard_heads``) and each sub-block's partial sum
        crosses the group via ``tp.psum`` — one planned all-reduce per
        attention and MLP, logits replicated."""
        cfg = self.cfg
        pos = positions[:, None]
        x = T.embed(params["io"], cfg, ctx, token)
        x, pool_caches = T.stack_apply(
            self.dec_segments, params["dec"], cfg, ctx, x,
            mode="decode", caches=pool_caches, positions=pos,
            page_table=page_table, tp=tp,
        )
        logits = T.logits_fn(params["io"], cfg, ctx, x)[:, 0]
        return logits, pool_caches

    # ------------------------------------------------------------------ #
    # dry-run stand-ins
    # ------------------------------------------------------------------ #
    def input_structs(self, shape: ShapeConfig) -> Dict[str, TensorSpec]:
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind == "train":
            batch = {
                "inputs": TensorSpec((B, S), i32),
                "targets": TensorSpec((B, S), i32),
                "mask": TensorSpec((B, S), torch.float32),
            }
        elif shape.kind == "prefill":
            batch = {"inputs": TensorSpec((B, S), i32)}
        else:  # decode
            batch = {"token": TensorSpec((B, 1), i32),
                     "positions": TensorSpec((B,), i32)}
        if shape.kind != "decode":
            if cfg.n_enc_layers:
                batch["frames"] = TensorSpec((B, S, cfg.d_model), cfg.dtype)
            elif cfg.cross_kv_len:
                batch["xkv"] = TensorSpec((B, cfg.cross_kv_len, cfg.d_model),
                                          cfg.dtype)
        return batch

    def input_specs(self, shape: ShapeConfig, ctx: RunCtx) -> Dict[str, P]:
        specs: Dict[str, P] = {}
        for k in self.input_structs(shape):
            if k in ("inputs", "targets", "mask", "token"):
                specs[k] = P(ctx.dp, None)
            elif k == "positions":
                specs[k] = P(ctx.dp)
            else:  # frames / xkv
                specs[k] = P(ctx.dp, None, None)
        return specs

    def cache_structs(self, shape: ShapeConfig, ctx: RunCtx) -> Any:
        """The cache tree a decode step of ``shape`` reads, as
        ``TensorSpec`` leaves: a prefill run on ``meta`` with a cache of
        ``S`` slots.  Prefill pads every cache to its length, so a short
        prompt gives the same shapes; an encoder's frames keep their
        ``S`` (the cross cache holds them)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        lctx = ctx_local(ctx)
        params, _ = self.abstract_init(lctx)
        batch = {"inputs": TensorSpec((B, min(S, PROMPT_STRUCT)), torch.int32)}
        if cfg.n_enc_layers:
            batch["frames"] = TensorSpec((B, S, cfg.d_model), cfg.dtype)
        elif cfg.cross_kv_len:
            batch["xkv"] = TensorSpec((B, cfg.cross_kv_len, cfg.d_model),
                                      cfg.dtype)
        _, caches = self.prefill(params, lctx, meta_tensors(batch),
                                 cache_len=S)
        return structs_of(caches)

    def cache_specs(self, cache_struct: Any, ctx: RunCtx) -> Any:
        """PartitionSpecs for a cache tree, by leaf name (the reference's
        rules)."""
        cfg = self.cfg
        tp_heads = ctx.tp_size and cfg.n_kv_heads % max(ctx.tp_size, 1) == 0

        def spec_for(path, leaf) -> P:
            name = path[-1]
            if name in ("k", "v"):  # (L, B, W, KH, Dh)
                if tp_heads:
                    return P(None, ctx.dp, None, ctx.tp, None)
                return P(None, ctx.dp, ctx.tp, None, None)
            if name == "pos":  # (L, B, W)
                if tp_heads:
                    return P(None, ctx.dp, None)
                return P(None, ctx.dp, ctx.tp)
            if name == "conv":  # (L, B, Wc-1, C)
                return P(None, ctx.dp, None, ctx.tp)
            if name == "ssm":  # (L, B, Di, N)
                return P(None, ctx.dp, ctx.tp, None)
            if name == "h":  # (L, B, W)
                return P(None, ctx.dp, ctx.tp)
            return P(*([None] * len(leaf.shape)))

        return tree_unflatten(cache_struct, [
            spec_for(path, leaf)
            for path, leaf in tree_flatten_with_path(cache_struct)])

    # ------------------------------------------------------------------ #
    def kv_block_struct(
        self, ctx: RunCtx, prompt_len: int, cache_len: int, batch: int = 1
    ) -> Any:
        """Shapes of the per-request cache tree :meth:`prefill` returns,
        computed from the config (the reference traces ``prefill`` with
        ``eval_shape``).  Independent of ``prompt_len``: prefill pads
        every attention cache to ``cache_len`` slots (a ``local`` block
        to its ring of ``min(local_window, cache_len)``; ``dense`` and
        ``moe`` blocks keep the ``global`` attention leaves); the
        recurrent blocks keep their conv window and state.  A ``cross``
        block's layout is a text-only prefill's (the servers pass only
        ``{"inputs"}``): both attention sub-blocks at ``cache_len``.  An
        encoder-decoder's prefill needs its ``frames``: it raises."""
        del prompt_len
        cfg = self.cfg
        f32 = torch.float32
        if cfg.n_enc_layers:
            raise ValueError(
                f"{cfg.name} is an encoder-decoder: its prefill needs "
                "batch['frames'], so it has no text-only cache layout")

        def attn(W: int, lead) -> Dict[str, Any]:
            tail = (cfg.n_kv_heads, cfg.resolved_head_dim)
            return {
                "k": TensorSpec(lead + (W,) + tail, cfg.dtype),
                "pos": TensorSpec(lead + (W,), torch.int32),
                "v": TensorSpec(lead + (W,) + tail, cfg.dtype),
            }

        def block(kind: str, lead) -> Dict[str, Any]:
            if kind in ("global", "local", "dense", "moe"):
                W = (min(cfg.local_window, cache_len) if kind == "local"
                     else cache_len)
                return {"attn": attn(W, lead)}
            if kind == "cross":
                return {"attn": attn(cache_len, lead),
                        "xattn": attn(cache_len, lead)}
            conv = (cfg.conv_width - 1,)
            if kind == "mamba":
                Di = cfg.resolved_d_inner
                return {"mix": {
                    "conv": TensorSpec(lead + conv + (Di,), cfg.dtype),
                    "ssm": TensorSpec(lead + (Di, cfg.ssm_state), f32),
                }}
            if kind == "rec":
                W = cfg.resolved_lru_width
                return {"mix": {
                    "conv": TensorSpec(lead + conv + (W,), cfg.dtype),
                    "h": TensorSpec(lead + (W,), f32),
                }}
            raise ValueError(f"no cache layout for {kind!r} blocks")

        return [
            {f"b{i}_{kind}": block(kind, (seg.count, batch))
             for i, kind in enumerate(seg.unit)}
            for seg in self.dec_segments
        ]


def ctx_local(ctx: RunCtx) -> RunCtx:
    """ctx variant with no mesh (for the structure derivation)."""
    return dataclasses.replace(ctx, mesh=None, moe_mode="local")


def meta_tensors(structs: Any) -> Any:
    """``TensorSpec`` leaves as unallocated ``meta`` tensors."""
    return tree_map(
        lambda st: torch.empty(st.shape, dtype=st.dtype, device="meta"),
        structs)


def structs_of(tree: Any) -> Any:
    """A tensor tree's shapes and dtypes as ``TensorSpec`` leaves."""
    return tree_map(lambda t: TensorSpec(tuple(t.shape), t.dtype), tree)


def build_model(cfg: ArchConfig) -> Model:
    enc = (build_layer_program(["enc"] * cfg.n_enc_layers)
           if cfg.n_enc_layers else None)
    return Model(cfg=cfg, dec_segments=build_layer_program(cfg.layer_kinds()),
                 enc_segments=enc)


def _to_torch(x: Any, device) -> torch.Tensor:
    a = np.array(x)  # a private, writable copy
    if a.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree: Any, device: Optional[Any] = "cpu") -> Any:
    """Map the reference's parameter tree (numpy leaves, same key paths,
    stacked ``(L, ...)`` leaves) onto the port's, by value."""
    return tree_map(lambda x: _to_torch(x, torch.device(device)), tree)
