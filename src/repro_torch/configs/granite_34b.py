"""granite-34b — llama-arch code model, MQA (kv=1) [arXiv:2405.04324]."""

import dataclasses

import torch

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    pattern=("global",),
    rope_theta=10000.0,
    mlp_gated=False,  # gpt-bigcode-style 2-matrix FFN
    act="gelu",
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=128, n_heads=8, n_kv_heads=1, head_dim=16,
    d_ff=256, vocab=512, dtype=torch.float32,
)
