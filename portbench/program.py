"""What the harness takes from the program under test (``repro_torch``,
under ``src/`` of the checkout): its configuration of an architecture,
its model, and the check that it lays out its parameters as the
benchmark makes them.  The drivers import the program's entry points
themselves; the reference imports nothing of it.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
from pathlib import Path
from typing import Any, Dict, Mapping

SRC = Path(__file__).resolve().parent.parent / "src"

# the configuration's ``model`` keys and the program's ArchConfig fields
FIELDS = {"layers": "n_layers", "d_model": "d_model", "n_heads": "n_heads",
          "n_kv_heads": "n_kv_heads", "head_dim": "head_dim", "d_ff": "d_ff",
          "vocab": "vocab", "d_inner": "d_inner", "ssm_state": "ssm_state",
          "conv_width": "conv_width", "dt_rank": "dt_rank",
          "rope_theta": "rope_theta", "mlp_gated": "mlp_gated",
          "tie_embeddings": "tie_embeddings"}
ACTS = {"gelu_tanh": "gelu", "silu": "silu"}


def import_path() -> None:
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


def arch_config(cfg: Mapping[str, Any]):
    """The program's ArchConfig of ``cfg["arch"]`` with the fields of
    ``cfg["model"]`` set, so that the program runs what the benchmark
    names."""
    import torch
    from repro_torch.configs.registry import ARCHS

    m = cfg["model"]
    base = ARCHS[cfg["arch"]]
    kw: Dict[str, Any] = {FIELDS[k]: v for k, v in m.items() if k in FIELDS}
    kw["dtype"] = getattr(torch, m["dtype"])
    out = dataclasses.replace(base, **kw)
    if "act" in m and ACTS[m["act"]] != out.act:
        raise ValueError(f"{cfg['name']}: act {m['act']} but the program's "
                         f"{out.act}")
    if m.get("norm", out.norm) != out.norm:
        raise ValueError(f"{cfg['name']}: norm {m['norm']} but the "
                         f"program's {out.norm}")
    return out


def free() -> None:
    """Return the program's freed memory to the card."""
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
