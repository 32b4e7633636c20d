"""Tensor-parallel decode groups: head/column sharding over GAS ranks.

Port of ``repro.parallel.tp``.  A *TP group* is ``tp`` GAS ranks jointly
serving one logical decode server: attention heads and MLP columns split
over the group, each rank holding only its shard of the weights (and, in
paged serving, only its heads' slice of the KV page pool).  The per-layer
partial sums meet in one all-reduce per sub-block — planned by
:mod:`repro_torch.core.sched` over the group's engine (software,
GAScore or a mixed :class:`~repro_torch.core.engine.EngineMap`).

The model layers stay pure: they receive a :class:`TPGroup` whose
``psum`` closes over whatever transport the caller runs under —
``sched.all_reduce`` inside ``Context.spmd`` for a real group, a sum
over the vmapped rank axis in tests, or the identity at ``tp=1``.

All ranks of a group live on one device: ``stack_shards`` lays the
shards side by side as ``(tp, ...)`` tensors, the operand
``Context.spmd`` lifts over the ``("tp",)`` axis.

Sharding is by parameter *name* on the port's tree (the reference's
keys; axes counted from the end so the rules hold for stacked leaves):

=============  ===========================  =========================
leaf           unstacked shape              shard
=============  ===========================  =========================
``wq/wk/wv``   (D, H, dh) / (D, KH, dh)     head axis (-2)
``wi``/``wg``  (D, F)                       columns (-1)
``wo``         (H*dh, D) or (F, D)          rows (-2; head-major)
MoE subtree    —                            replicated
everything     norms, router, io, gates     replicated
=============  ===========================  =========================

Every sharded matmul's partial output is summed by ``tp.psum``; all
activations (and therefore the logits) are replicated across the group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.compat import tree_flatten_with_path, tree_map, tree_unflatten

__all__ = [
    "TPGroup",
    "validate_tp",
    "shard_axis_for",
    "shard_decode_params",
    "stack_shards",
]


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """One tensor-parallel decode group, as seen from inside a layer.

    ``size`` — number of ranks in the group.
    ``psum`` — sum a partial activation over the group; must be callable
               from inside the rank-lifted program (the engine
               collectives under ``Context.spmd`` qualify).
    """

    size: int
    psum: Callable[[torch.Tensor], torch.Tensor]

    def maybe_psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x) if self.size > 1 else x


def validate_tp(cfg: Any, tp: int) -> None:
    """TP degree must divide both head counts (GQA group size preserved:
    each rank keeps H/tp query heads over KH/tp KV heads)."""
    if tp <= 1:
        return
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads} and "
            f"n_kv_heads={cfg.n_kv_heads}"
        )


def shard_axis_for(path: Sequence[Any]) -> Optional[int]:
    """The axis (negative, from the end) a leaf shards over, or None to
    replicate.  ``path`` is the leaf's key path (``compat``'s
    ``tree_flatten_with_path``)."""
    names = [str(p) for p in path]
    if "moe" in names:  # the whole MoE subtree (incl. shared/dense_res)
        return None
    name = names[-1] if names else ""
    if name in ("wq", "wk", "wv"):
        return -2
    if name in ("wi", "wg"):
        return -1
    if name == "wo":
        return -2
    return None


def _slice_axis(x: torch.Tensor, axis: int, tp: int, rank: int) -> torch.Tensor:
    n = x.shape[axis]
    if n % tp:
        raise ValueError(
            f"cannot shard axis {axis} of shape {tuple(x.shape)} over tp={tp}"
        )
    k = n // tp
    return x.narrow(axis, rank * k, k)


def shard_decode_params(params: Any, tp: int, rank: int) -> Any:
    """Rank ``rank``'s parameter shard (views; replicated leaves pass
    through)."""
    if tp <= 1:
        return params
    leaves = []
    for path, leaf in tree_flatten_with_path(params):
        ax = shard_axis_for(path)
        leaves.append(leaf if ax is None else _slice_axis(leaf, ax, tp, rank))
    return tree_unflatten(params, leaves)


def stack_shards(params: Any, tp: int) -> Any:
    """Stack all ranks' shards on a new leading axis: the ``(tp, ...)``
    operand ``Context.spmd`` lifts over the group, one shard per rank
    (replicated leaves are duplicated, as in the reference — at decode
    scale the KV pool dominates memory, not the weights)."""
    shards = [shard_decode_params(params, tp, r) for r in range(tp)]
    return tree_map(lambda *xs: torch.stack(xs), *shards)
