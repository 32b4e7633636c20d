"""Architecture registry of the port.

The port serves qwen3-4b so far; the other architectures of
``repro.configs.registry`` join as their block kinds are ported.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import qwen3_4b
from repro_torch.models.common import ArchConfig

_MODULES = {
    "qwen3-4b": qwen3_4b,
}

ARCHS: Dict[str, ArchConfig] = {k: m.CONFIG for k, m in _MODULES.items()}
SMOKE: Dict[str, ArchConfig] = {k: m.SMOKE for k, m in _MODULES.items()}
