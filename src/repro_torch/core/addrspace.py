"""Partitioned Global Address Space (PGAS) segments on one device.

The paper's GASNet nodes each expose a *segment* of memory that remote nodes
may read/write with one-sided operations.  As in the reference
(``repro.core.addrspace``), a segment is a single global tensor with a
leading node dimension:

    segment tensor shape = (n_nodes, *local_shape)

All ranks' partitions live on ONE device (an H100 by default); inside
``Context.spmd`` the node program is lifted over the rank axis with
``torch.func.vmap``, and every rank sees its own ``(1, *local_shape)``
partition — exactly the view ``shard_map`` gives the reference.  A global
address is ``(node_id, local_index)``, the paper's addressing model.

Segments are values: one-sided writes return an updated segment tensor.
The :class:`AddressSpace` holds only metadata and the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import compat

__all__ = ["SegmentSpec", "AddressSpace", "GlobalAddress", "PartitionSpec", "P"]


@dataclasses.dataclass(frozen=True)
class GlobalAddress:
    """A (node, index) pair addressing one element range of a segment."""

    node: int
    index: int

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"gaddr(node={self.node}, index={self.index})"


class PartitionSpec(tuple):
    """The port's ``jax.sharding.PartitionSpec``: one entry per dimension,
    an axis name, a tuple of names (``("pod", "data")``) or None.  For
    ``Context.spmd``, ``P("node")`` splits the leading dimension over the
    ranks and ``P()`` replicates.  Entries are normalised as JAX's are: a
    list becomes a tuple, a one-name tuple its name, an empty one None."""

    def __new__(cls, *axes: Any):
        def norm(entry):
            if isinstance(entry, (tuple, list)):
                entry = tuple(entry)
                return entry[0] if len(entry) == 1 else (entry or None)
            return entry

        return super().__new__(cls, tuple(norm(a) for a in axes))

    @property
    def sharded(self) -> bool:
        return len(self) > 0 and self[0] is not None

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class SegmentSpec:
    """Static description of one PGAS segment.

    Attributes:
      name:        registry key.
      local_shape: per-node shape (the partition owned by one node).
      dtype:       element type.
    """

    name: str
    local_shape: Tuple[int, ...]
    dtype: Any

    @property
    def local_size(self) -> int:
        size = 1
        for d in self.local_shape:
            size *= d
        return size

    def global_shape(self, n_nodes: int) -> Tuple[int, ...]:
        return (n_nodes,) + tuple(self.local_shape)


class AddressSpace:
    """Registry of named PGAS segments over ``n_nodes`` ranks on ``device``.

    This mirrors ``gasnet_attach()``: every node contributes an equally sized
    partition per segment.  ``alloc`` produces the rank-stacked tensor.
    ``device`` defaults to CUDA (see ``compat.resolve_device``).
    """

    def __init__(self, n_nodes: int, device: Any = None, node_axis: str = "node"):
        if n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
        self._n_nodes = int(n_nodes)
        self.device = compat.resolve_device(device)
        self.node_axis = node_axis
        self._specs: Dict[str, SegmentSpec] = {}

    # ------------------------------------------------------------------ #
    # registry
    # ------------------------------------------------------------------ #
    @property
    def n_nodes(self) -> int:
        return self._n_nodes

    @property
    def specs(self) -> Dict[str, SegmentSpec]:
        return dict(self._specs)

    def register(
        self,
        name: str,
        local_shape: Tuple[int, ...],
        dtype: Any = torch.float32,
    ) -> SegmentSpec:
        if name in self._specs:
            raise ValueError(f"segment {name!r} already registered")
        spec = SegmentSpec(name=name, local_shape=tuple(local_shape), dtype=dtype)
        self._specs[name] = spec
        return spec

    def spec(self, name: str) -> SegmentSpec:
        return self._specs[name]

    # ------------------------------------------------------------------ #
    # allocation & addressing
    # ------------------------------------------------------------------ #
    def alloc(
        self,
        name: str,
        init_fn: Callable[..., torch.Tensor] = torch.zeros,
    ) -> torch.Tensor:
        """Materialize a segment as a rank-stacked tensor on the device."""
        spec = self._specs[name]
        shape = spec.global_shape(self.n_nodes)
        return init_fn(shape, dtype=spec.dtype, device=self.device)

    def alloc_from(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """Place an existing (n_nodes, *local_shape) tensor into the segment."""
        spec = self._specs[name]
        expect = spec.global_shape(self.n_nodes)
        if tuple(value.shape) != expect:
            raise ValueError(
                f"segment {name!r} expects shape {expect}, got "
                f"{tuple(value.shape)}"
            )
        return value.to(device=self.device, dtype=spec.dtype)

    # ------------------------------------------------------------------ #
    # host-side (test/debug) accessors
    # ------------------------------------------------------------------ #
    def read(
        self, seg: torch.Tensor, addr: GlobalAddress, length: int
    ) -> torch.Tensor:
        """Host-side read of ``length`` flat elements at a global address."""
        local = seg[addr.node].reshape(-1)
        return local[addr.index : addr.index + length]

    def in_specs(self) -> PartitionSpec:
        """PartitionSpec of any segment for ``Context.spmd`` in/out specs."""
        return P(self.node_axis)
