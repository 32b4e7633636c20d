"""KV-cache carrier format of the port: bit-transparent float32 blocks.

Counterpart of ``repro.serving.kv`` (the data-plane half that needs no
GAS layer): :class:`KVLayout` maps a cache tree to one flat float32
*carrier* vector and back, bit-exactly.  Int leaves are bitcast with
``Tensor.view`` (never converted), half-precision floats widen exactly.
``push_block`` waits for the port's GAS layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch

from repro_torch.compat import tree_leaves, tree_unflatten

__all__ = ["KVLayout", "LeafSpec", "carrier_cast", "carrier_uncast"]

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
