"""Run context of the port: the reference's ``RunCtx`` without a mesh.

The port runs on one device, so sharding constraints and FSDP
unshard-at-use are the identity; the context keeps the knobs the
single-device model code reads.
"""

from __future__ import annotations

import dataclasses

__all__ = ["REMAT_POLICIES", "SCAN_IMPLS", "RunCtx", "shard", "use_weight"]


REMAT_POLICIES = ("none", "full", "dots", "names")
SCAN_IMPLS = ("ref", "pallas", "chunked")


@dataclasses.dataclass(frozen=True)
class RunCtx:
    attn_chunk: int = 512  # query block of the prefill attention
    # training: "full" recomputes each layer's forward in the backward
    # (the reference's ``jax.checkpoint``), "none" keeps its activations;
    # "dots" saves the matrix products without batch dims and "names" the
    # sub-block outputs (attn_out, mlp_out, moe_out, mix_out), recomputing
    # the rest (the reference's two checkpoint policies)
    remat: str = "full"
    # the scans: "ref" and "pallas" dispatch by device (the hand kernel on
    # CUDA, the plain scan on the CPU); "chunked" runs the chunked
    # associative scans of ``kernels/ref.py`` on either device
    scan_impl: str = "ref"

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            raise ValueError(
                f"remat {self.remat!r}: the port has {REMAT_POLICIES}"
            )
        if self.scan_impl not in SCAN_IMPLS:
            raise ValueError(
                f"scan_impl {self.scan_impl!r}: the port has {SCAN_IMPLS}"
            )


def use_weight(w, ctx: RunCtx, spec=None):
    """Identity: weights are whole on the one device."""
    return w


def shard(x, ctx: RunCtx, spec=None):
    """Identity: no mesh, no sharding constraint."""
    return x
