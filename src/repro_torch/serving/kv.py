"""KV-cache blocks over the GAS layer: the disaggregated-serving data plane.

Counterpart of ``repro.serving.kv``.  A prefill rank finishes a request
holding a KV cache; a decode rank needs it installed in one of its
staging slots.  The bulk bytes move as one-sided puts (``Node.put_nb``,
segmented per ``sched.plan_p2p``); the control packet announcing the
block rides the Active Message plane (``repro_torch.serving.disagg``).

1. :class:`KVLayout` maps a cache tree to one flat float32 *carrier*
   vector and back, bit-exactly.  Int leaves are bitcast with
   ``Tensor.view`` (never converted), half-precision floats widen exactly.
2. :func:`push_block` ships a block as planned segmented split-phase
   puts, all initiated before any completes; :func:`sync_push` lands them
   in the program, or ``Node.defer`` hands each landing to the caller
   (``extended.land``, in place: the cluster's segments are too large to
   copy per put).
3. :func:`handoff_permutation` completes prefill→decode edges into a
   bijection (the GAScore transports take bijections only); filler edges
   carry ``pred=False`` puts the receiver discards.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.compat import tree_leaves, tree_unflatten
from repro_torch.core import sched

__all__ = [
    "KVLayout",
    "LeafSpec",
    "carrier_cast",
    "carrier_uncast",
    "segment_bounds",
    "push_block",
    "sync_push",
    "handoff_permutation",
]

_SMALL_INTS = (torch.int8, torch.int16, torch.uint8)


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One cache leaf's slice of the flat carrier block."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    offset: int
    size: int


def carrier_cast(x: torch.Tensor) -> torch.Tensor:
    """Bit-transparent elementwise cast of one leaf into the float32
    carrier (shape-preserving)."""
    if x.dtype == torch.float32:
        return x
    if x.dtype == torch.int32:
        return x.view(torch.float32)
    if x.dtype in _SMALL_INTS:
        return x.to(torch.int32).view(torch.float32)
    if x.dtype == torch.bool:
        return x.to(torch.float32)
    if x.dtype.is_floating_point:
        return x.to(torch.float32)  # bf16/f16 widen exactly
    raise TypeError(f"unsupported KV leaf dtype {x.dtype}")


def carrier_uncast(flat: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`carrier_cast` (shape-preserving)."""
    if dtype == torch.float32:
        return flat
    if dtype == torch.int32:
        return flat.view(torch.int32)
    if dtype in _SMALL_INTS:
        return flat.view(torch.int32).to(dtype)
    if dtype == torch.bool:
        return flat != 0.0
    if dtype.is_floating_point:
        return flat.to(dtype)
    raise TypeError(f"unsupported KV leaf dtype {dtype}")


class KVLayout:
    """Static block layout of one request's KV cache: :meth:`flatten` /
    :meth:`unflatten` round-trip any cache of the structure through a
    single ``(total,)`` float32 carrier vector, bit-exactly."""

    def __init__(self, treedef: Any, leaves: List[LeafSpec]):
        self.treedef = treedef
        self.leaves = leaves
        self.total = sum(leaf.size for leaf in leaves)

    @classmethod
    def from_struct(cls, struct: Any) -> "KVLayout":
        leaves: List[LeafSpec] = []
        offset = 0
        for s in tree_leaves(struct):
            size = 1
            for d in s.shape:
                size *= int(d)
            leaves.append(LeafSpec(tuple(s.shape), s.dtype, offset, size))
            offset += size
        return cls(struct, leaves)

    @property
    def nbytes(self) -> int:
        return self.total * 4  # float32 carrier

    def flatten(self, caches: Any) -> torch.Tensor:
        vals = tree_leaves(caches)
        if len(vals) != len(self.leaves):
            raise ValueError(
                f"cache has {len(vals)} leaves, layout expects "
                f"{len(self.leaves)}"
            )
        return torch.cat([carrier_cast(v).reshape(-1) for v in vals])

    def unflatten(self, flat: torch.Tensor) -> Any:
        flat = flat.reshape(-1)
        if flat.shape[0] != self.total:
            raise ValueError(
                f"flat block has {flat.shape[0]} elems, layout expects "
                f"{self.total}"
            )
        vals = [
            carrier_uncast(
                flat[leaf.offset : leaf.offset + leaf.size], leaf.dtype
            ).reshape(leaf.shape)
            for leaf in self.leaves
        ]
        return tree_unflatten(self.treedef, vals)


def segment_bounds(total: int, n_segments: int) -> List[Tuple[int, int]]:
    """Static ``(offset, size)`` list cutting ``total`` elements into at
    most ``n_segments`` contiguous near-equal segments (never empty)."""
    g = max(1, min(int(n_segments), int(total)))
    base, rem = divmod(int(total), g)
    bounds: List[Tuple[int, int]] = []
    offset = 0
    for i in range(g):
        size = base + (1 if i < rem else 0)
        bounds.append((offset, size))
        offset += size
    return bounds


def push_block(
    node: Any,
    seg: torch.Tensor,
    flat: torch.Tensor,
    *,
    to: Any,
    base_index: Any = 0,
    pred: Any = None,
    plan: Optional[sched.CollectivePlan] = None,
    n_segments: Optional[int] = None,
    costs: Optional[Dict[str, sched.EngineCost]] = None,
) -> Tuple[List[Any], sched.CollectivePlan]:
    """Initiate one KV-block transfer as planned segmented non-blocking puts.

    The segment count comes from ``sched.plan_p2p`` unless pinned via
    ``n_segments``.  Every segment's ``put_nb`` is initiated here — all in
    flight at once — and the caller drains them with :func:`sync_push` (or
    ``Node.defer``) after issuing any compute it wants overlapped.

    Returns ``(handles, plan)``.
    """
    flat = flat.reshape(-1)
    if plan is None:
        nbytes = int(flat.numel()) * flat.element_size()
        plan = sched.plan_p2p(nbytes=nbytes, engine=node.engine, costs=costs)
    g = int(plan.n_segments if n_segments is None else n_segments)
    handles = []
    for offset, size in segment_bounds(int(flat.numel()), g):
        handles.append(
            node.put_nb(
                seg,
                flat[offset : offset + size],
                to=to,
                index=base_index + offset,
                pred=pred,
            )
        )
    return handles, plan


def sync_push(node: Any, seg: torch.Tensor, handles: Sequence[Any]) -> torch.Tensor:
    """Drain one block's put handles in issue order; returns the updated
    segment (outstanding puts on the same segment compose, see
    ``Node.sync``)."""
    for h in handles:
        seg = node.sync(h)
    return seg


def handoff_permutation(n_nodes: int, edges: Dict[int, int]) -> Tuple[int, ...]:
    """Complete prefill→decode ``edges`` (src rank -> dst rank) into a full
    bijection over ``n_nodes`` ranks.

    Hardware (GAScore) transports are bijection-only — every receive
    semaphore fires exactly once — so ranks without a real edge get filler
    destinations in stable order; their puts ship ``pred=False`` and the
    receivers keep their memory untouched.
    """
    dst: List[Optional[int]] = [None] * n_nodes
    used = set()
    for s, d in edges.items():
        if not (0 <= s < n_nodes and 0 <= d < n_nodes):
            raise ValueError(f"edge {s}->{d} outside {n_nodes} ranks")
        if dst[s] is not None:
            raise ValueError(f"duplicate source rank {s}")
        if d in used:
            raise ValueError(f"duplicate destination rank {d}")
        dst[s] = d
        used.add(d)
    remaining = [r for r in range(n_nodes) if r not in used]
    for s in range(n_nodes):
        if dst[s] is None:
            dst[s] = remaining.pop(0)
    assert not remaining
    return tuple(dst)  # type: ignore[arg-type]
