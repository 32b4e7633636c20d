"""Architecture registry of the port.

The port runs qwen3-4b, falcon-mamba-7b, recurrentgemma-9b and the two
MoE archs, kimi-k2-1t-a32b and arctic-480b, so far; the other
architectures of ``repro.configs.registry`` join as their
block kinds are ported.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import (
    arctic_480b,
    falcon_mamba_7b,
    kimi_k2_1t,
    qwen3_4b,
    recurrentgemma_9b,
)
from repro_torch.models.common import ArchConfig

_MODULES = {
    "qwen3-4b": qwen3_4b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "kimi-k2-1t-a32b": kimi_k2_1t,
    "arctic-480b": arctic_480b,
}

ARCHS: Dict[str, ArchConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE: Dict[str, ArchConfig] = {k: m.SMOKE for k, m in _MODULES.items()}
