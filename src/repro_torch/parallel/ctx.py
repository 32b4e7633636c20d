"""Run context of the port: the reference's ``RunCtx`` without a mesh.

The port runs on one device, so sharding constraints and FSDP
unshard-at-use are the identity; the context keeps the knobs the
single-device model code reads.  Expert parallelism keeps the
reference's mesh shape as ``ep_grid``: ``(data, model)`` ranks of GAS
engines, all on the one device (``models.layers._moe_ep``).
"""

from __future__ import annotations

import dataclasses

__all__ = ["MOE_BACKENDS", "MOE_MODES", "REMAT_POLICIES", "SCAN_IMPLS",
           "RunCtx", "shard", "use_weight"]


REMAT_POLICIES = ("none", "full", "dots", "names")
SCAN_IMPLS = ("ref", "pallas", "chunked")
MOE_MODES = ("auto", "ep_shardmap", "local")
MOE_BACKENDS = ("xla", "gascore")


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
    # the MoE FFN: "local" routes every token on one rank; "ep_shardmap"
    # shards experts over the model ranks of ``ep_grid`` and moves tokens
    # by the ``moe_backend`` engine's all-to-all; "auto" takes EP when the
    # grid has model ranks, they divide the experts and the data ranks
    # divide the tokens (the reference's rule)
    moe_mode: str = "auto"
    moe_backend: str = "xla"
    # EP ranks (data, model): the stand-in for the reference's mesh shape
    ep_grid: tuple = (1, 1)

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            raise ValueError(
                f"remat {self.remat!r}: the port has {REMAT_POLICIES}"
            )
        if self.scan_impl not in SCAN_IMPLS:
            raise ValueError(
                f"scan_impl {self.scan_impl!r}: the port has {SCAN_IMPLS}"
            )
        if self.moe_mode not in MOE_MODES:
            raise ValueError(f"moe_mode {self.moe_mode!r}: one of {MOE_MODES}")
        if self.moe_backend not in MOE_BACKENDS:
            raise ValueError(
                f"moe_backend {self.moe_backend!r}: one of {MOE_BACKENDS}")
        grid = tuple(int(n) for n in self.ep_grid)
        if len(grid) != 2 or min(grid) < 1:
            raise ValueError(f"ep_grid {self.ep_grid!r}: (data, model) >= 1")
        object.__setattr__(self, "ep_grid", grid)


def use_weight(w, ctx: RunCtx, spec=None):
    """Identity: weights are whole on the one device."""
    return w


def shard(x, ctx: RunCtx, spec=None):
    """Identity: no mesh, no sharding constraint."""
    return x
