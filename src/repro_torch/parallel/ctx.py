"""Run context of the port: the reference's ``RunCtx`` without a mesh.

The port runs on one device, so sharding constraints and FSDP
unshard-at-use are the identity; the context keeps the knobs the
single-device model code reads.
"""

from __future__ import annotations

import dataclasses

__all__ = ["REMAT_POLICIES", "RunCtx", "shard", "use_weight"]


REMAT_POLICIES = ("none", "full")


@dataclasses.dataclass(frozen=True)
class RunCtx:
    attn_chunk: int = 512  # query block of the prefill attention
    # training: "full" recomputes each layer's forward in the backward
    # (the reference's ``jax.checkpoint``), "none" keeps its activations
    remat: str = "full"

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            raise ValueError(
                f"remat {self.remat!r}: the port has {REMAT_POLICIES}"
            )


def use_weight(w, ctx: RunCtx, spec=None):
    """Identity: weights are whole on the one device."""
    return w


def shard(x, ctx: RunCtx, spec=None):
    """Identity: no mesh, no sharding constraint."""
    return x
