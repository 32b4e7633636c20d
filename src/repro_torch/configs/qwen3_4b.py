"""qwen3-4b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family]."""

import dataclasses

import torch

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    pattern=("global",),
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    CONFIG,
    n_layers=4,
    d_model=128,
    n_heads=8,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab=512,
    dtype=torch.float32,
)
