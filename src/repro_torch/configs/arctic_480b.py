"""arctic-480b — dense-MoE hybrid: every layer has a parallel dense
residual FFN plus 128-expert top-2 MoE [hf:Snowflake/snowflake-arctic-base]."""

import dataclasses

import torch

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    pattern=("moe",),
    n_experts=128,
    top_k=2,
    capacity_factor=1.25,
    moe_dense_residual=True,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=128, vocab=512, n_experts=8, top_k=2, dtype=torch.float32,
)
