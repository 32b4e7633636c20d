"""recurrentgemma-9b — griffin: RG-LRU + local attention 1:2
[arXiv:2402.19427].  38 layers = (rec, rec, local) x 12 + (rec, rec)."""

import dataclasses

import torch

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    pattern=("rec", "rec", "local"),
    local_window=2048,
    lru_width=4096,
    conv_width=4,
    tie_embeddings=True,
    sub_quadratic=True,
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=5, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
    d_ff=256, vocab=512, lru_width=128, local_window=16, dtype=torch.float32,
)
