"""Architecture registry of the port.

The port runs qwen3-4b, falcon-mamba-7b and recurrentgemma-9b so far;
the other architectures of ``repro.configs.registry`` join as their
block kinds are ported.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import falcon_mamba_7b, qwen3_4b, recurrentgemma_9b
from repro_torch.models.common import ArchConfig

_MODULES = {
    "qwen3-4b": qwen3_4b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "recurrentgemma-9b": recurrentgemma_9b,
}

ARCHS: Dict[str, ArchConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE: Dict[str, ArchConfig] = {k: m.SMOKE for k, m in _MODULES.items()}
