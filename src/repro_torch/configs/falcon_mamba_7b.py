"""falcon-mamba-7b — attention-free mamba1 [arXiv:2410.05355]."""

import dataclasses

import torch

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,  # unused
    d_ff=0,
    vocab=65024,
    pattern=("mamba",),
    ssm_state=16,
    d_inner=8192,
    conv_width=4,
    dt_rank=256,
    sub_quadratic=True,
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=128, d_inner=256, dt_rank=8, vocab=512,
    dtype=torch.float32,
)
