"""gemma3-27b — 5:1 local:global attention, 256k vocab, 128k ctx
[hf:google/gemma-3 family].  Local window 1024; the local-dominated
pattern makes long_500k decode sub-quadratic-eligible."""

import dataclasses

import torch

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    pattern=("local", "local", "local", "local", "local", "global"),
    local_window=1024,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    sub_quadratic=True,
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=8, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab=512, local_window=16, dtype=torch.float32,
)
