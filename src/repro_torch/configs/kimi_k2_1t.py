"""kimi-k2-1t-a32b — trillion-param MoE: 384 experts top-8, one shared
expert, first layer dense [Kimi K2 paper table].  The dense first layer's
d_ff is set active-parameter-matched (top_k * expert d_ff) since the
assignment table specifies only the expert width.

Copied by value from the reference package's config.  It departs from the
published model (moonshotai/Kimi-K2-Instruct): GQA with 8 KV heads in
place of multi-head latent attention, a dense d_ff of 16384 in place of
18432, and a softmax router in place of a sigmoid one with a
bias-corrected top-k and a routed scaling factor."""

import dataclasses

import torch

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab=163840,
    pattern=("moe",),
    n_experts=384,
    top_k=8,
    capacity_factor=1.25,
    n_shared_experts=1,
    first_dense_layers=1,
    d_ff_dense=16384,
    rope_theta=50000.0,
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=64, vocab=512, n_experts=8, top_k=2, d_ff_dense=256,
    dtype=torch.float32,
)
