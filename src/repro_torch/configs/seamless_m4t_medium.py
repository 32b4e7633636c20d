"""seamless-m4t-medium — encoder-decoder, multimodal [arXiv:2308.11596].
The speech/text frontend is a STUB: input_specs provides precomputed frame
embeddings (B, S, d_model) for the encoder."""

import dataclasses

import torch

from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,        # decoder
    n_enc_layers=12,    # encoder
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    pattern=("xdec",),
    norm="layernorm",
    act="gelu",
    mlp_gated=False,  # classic transformer FFN
    dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, n_enc_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, head_dim=32, d_ff=256, vocab=512, dtype=torch.float32,
)
