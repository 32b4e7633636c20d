"""llama3-405b — dense GQA transformer, 128k vocab [arXiv:2407.21783]."""

import dataclasses

import torch

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab=128256,
    pattern=("global",),
    rope_theta=500000.0,
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=256, vocab=512, dtype=torch.float32,
)
