"""llama-3.2-vision-11b — text backbone with gated cross-attention image
layers every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision].  The vision
tower is a STUB per the assignment: input_specs provides precomputed patch
embeddings (B, 1601, d_model)."""

import dataclasses

import torch

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    pattern=("global", "global", "global", "global", "cross"),
    cross_kv_len=1601,
    rope_theta=500000.0,
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=5, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, cross_kv_len=17, dtype=torch.float32,
)
