"""Architecture + shape registry of the port: the 40 (arch × shape) cells
of ``repro.configs.registry``, configs copied by value."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.configs import (
    arctic_480b,
    falcon_mamba_7b,
    gemma3_27b,
    granite_34b,
    kimi_k2_1t,
    llama3_405b,
    llama32_vision_11b,
    qwen3_4b,
    recurrentgemma_9b,
    seamless_m4t_medium,
)
from repro_torch.models.common import ArchConfig

__all__ = ["ARCHS", "SMOKE", "SHAPES", "ShapeConfig", "all_cells",
           "cell_runnable", "runnable_cells"]

_MODULES = {
    "llama3-405b": llama3_405b,
    "granite-34b": granite_34b,
    "qwen3-4b": qwen3_4b,
    "gemma3-27b": gemma3_27b,
    "arctic-480b": arctic_480b,
    "kimi-k2-1t-a32b": kimi_k2_1t,
    "falcon-mamba-7b": falcon_mamba_7b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "llama-3.2-vision-11b": llama32_vision_11b,
    "seamless-m4t-medium": seamless_m4t_medium,
}

ARCHS: Dict[str, ArchConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE: Dict[str, ArchConfig] = {k: m.SMOKE for k, m in _MODULES.items()}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell (the reference's
    ``repro.models.build.ShapeConfig``)."""

    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def cell_runnable(arch: str, shape: str) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and why not if skipped:
    ``long_500k`` needs sub-quadratic attention (SSM, hybrid or
    local-attention-dominated archs)."""
    cfg = ARCHS[arch]
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a in ARCHS for s in SHAPES]


def runnable_cells() -> List[Tuple[str, str]]:
    return [(a, s) for a, s in all_cells() if cell_runnable(a, s)[0]]
