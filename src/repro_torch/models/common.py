"""Architecture configuration schema + the layer-program machinery.

The port of ``repro.models.common``: an :class:`ArchConfig` plus a
repeating *pattern* of block kinds, compiled into :class:`Segment`\\ s —
maximal runs of identical repeating units.  The reference scans each
segment over stacked layer parameters; the port loops over the stacked
leading axis, with the same parameter layout.

Block kinds:

- ``global``  — GQA self-attention (full causal) + MLP
- ``local``   — GQA self-attention (sliding window) + MLP
- ``moe``     — GQA self-attention + mixture-of-experts FFN
- ``dense``   — like ``global`` (used for MoE models' leading dense layers)
- ``mamba``   — mamba1 selective-SSM mixer (no MLP)
- ``rec``     — RG-LRU recurrent mixer + MLP (griffin/recurrentgemma)
- ``cross``   — GQA self-attention + gated cross-attention + MLP (VLM)
- ``enc``     — bidirectional self-attention + MLP (encoder stacks)
- ``xdec``    — causal self-attention + encoder cross-attention + MLP
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["ArchConfig", "Segment", "build_layer_program", "KNOWN_KINDS"]

KNOWN_KINDS = (
    "global",
    "local",
    "moe",
    "dense",
    "mamba",
    "rec",
    "cross",
    "enc",
    "xdec",
)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Static description of one architecture (exact published numbers)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[str, ...] = ("global",)
    head_dim: Optional[int] = None
    qk_norm: bool = False
    local_window: int = 1024
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | gelu
    mlp_gated: bool = True  # SwiGLU-style; False = classic 2-matrix FFN
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # arctic: parallel dense FFN
    n_shared_experts: int = 0  # kimi: always-on experts
    first_dense_layers: int = 0  # kimi: leading dense layers
    d_ff_dense: Optional[int] = None  # d_ff of dense/residual FFN if different
    # --- SSM (mamba1) ---
    ssm_state: int = 16
    d_inner: int = 0  # 0 -> 2 * d_model
    conv_width: int = 4
    dt_rank: int = 0  # 0 -> d_model // 16
    # --- hybrid (RG-LRU) ---
    lru_width: int = 0  # 0 -> d_model
    # --- VLM / enc-dec frontends (stubs provide the embeddings) ---
    cross_kv_len: int = 0  # vision tokens / encoder length for cross blocks
    n_enc_layers: int = 0  # encoder stack depth (seamless)
    # --- numerics ---
    dtype: torch.dtype = torch.bfloat16
    sub_quadratic: bool = False  # eligible for long_500k decode

    def __post_init__(self):
        for k in self.pattern:
            if k not in KNOWN_KINDS:
                raise ValueError(f"unknown block kind {k!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def resolved_d_inner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.dt_rank or max(self.d_model // 16, 1)

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def resolved_d_ff_dense(self) -> int:
        return self.d_ff_dense or self.d_ff

    @property
    def attention_free(self) -> bool:
        return all(k == "mamba" for k in self.pattern)

    def layer_kinds(self) -> List[str]:
        """Per-layer kinds for the decoder stack (length n_layers): the
        leading ``dense`` layers, then the pattern repeated."""
        kinds = ["dense"] * self.first_dense_layers
        kinds += [self.pattern[i % len(self.pattern)]
                  for i in range(max(self.n_layers - len(kinds), 0))]
        return kinds[: self.n_layers]

    def param_counts(self) -> Tuple[int, int]:
        """(total_params, active_params) of the decoder's and the
        encoder's matrices, the embedding included once: the reference's
        ``param_counts`` (norms, biases and gates left out)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        H, KH, Dh = self.n_heads, self.n_kv_heads, self.resolved_head_dim
        total = V * D * (1 if self.tie_embeddings else 2)
        active = total
        attn = D * H * Dh + 2 * D * KH * Dh + H * Dh * D

        def mlp(f: int) -> int:
            return (3 if self.mlp_gated else 2) * D * f  # wi, [wg,] wo

        for kind in self.layer_kinds():
            if kind in ("global", "local", "dense", "enc"):
                p = attn + mlp(self.resolved_d_ff_dense if kind == "dense"
                               else F)
                total, active = total + p, active + p
            elif kind == "moe":
                p = (attn + D * self.n_experts + self.n_shared_experts * mlp(F)
                     + (mlp(self.resolved_d_ff_dense)
                        if self.moe_dense_residual else 0))
                total += p + self.n_experts * mlp(F)
                active += p + self.top_k * mlp(F)
            elif kind == "mamba":
                Di, N, R = (self.resolved_d_inner, self.ssm_state,
                            self.resolved_dt_rank)
                p = (D * 2 * Di + self.conv_width * Di + Di * (R + 2 * N)
                     + R * Di + Di * N + Di + Di * D)
                total, active = total + p, active + p
            elif kind == "rec":
                W = self.resolved_lru_width
                p = (2 * D * W + self.conv_width * W + 2 * W * W + W + W * D
                     + mlp(F))
                total, active = total + p, active + p
            elif kind in ("cross", "xdec"):
                p = 2 * attn + mlp(F)
                total, active = total + p, active + p
        enc = self.n_enc_layers * (attn + mlp(F))
        return total + enc, active + enc


@dataclasses.dataclass(frozen=True)
class Segment:
    """A maximal run of identical repeating units.

    ``unit``: tuple of block kinds applied in order per iteration.
    ``count``: number of iterations (stacked-parameter leading dim).
    """

    unit: Tuple[str, ...]
    count: int

    @property
    def n_layers(self) -> int:
        return len(self.unit) * self.count


def build_layer_program(kinds: Sequence[str], max_unit: int = 8) -> List[Segment]:
    """Compile a per-layer kind list into segments.

    Greedy: find the shortest repeating unit (length <= max_unit) covering a
    maximal prefix, emit it as a Segment, recurse on the rest.  Guarantees
    segment order == layer order.
    """
    kinds = list(kinds)
    segments: List[Segment] = []
    i = 0
    n = len(kinds)
    while i < n:
        best = (1, 1)  # (unit_len, count)
        for ul in range(1, min(max_unit, n - i) + 1):
            unit = kinds[i : i + ul]
            count = 1
            while (
                i + (count + 1) * ul <= n
                and kinds[i + count * ul : i + (count + 1) * ul] == unit
            ):
                count += 1
            if count * ul > best[0] * best[1] or (
                count * ul == best[0] * best[1] and ul < best[0]
            ):
                best = (ul, count)
        ul, count = best
        segments.append(Segment(unit=tuple(kinds[i : i + ul]), count=count))
        i += ul * count
    if sum(s.n_layers for s in segments) != n:
        raise AssertionError("layer program does not cover every layer")
    return segments
