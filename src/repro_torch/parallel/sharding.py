"""Sharding utilities of the port: divisibility-safe spec resolution.

The port of ``repro.parallel.sharding``.  The reference's explicit jit
``in_shardings`` are strict: a dimension must be exactly divisible by the
product of its mesh axes.  Real configs violate this routinely — vocab
256206, 1601 vision tokens, 56 attention heads, batch-1 long-context
decode — so every spec goes through :func:`sanitize`, which drops the
axis assignment of any non-dividing dimension (replication for that dim,
the conservative-but-correct choice; e.g. arctic's 56 heads stay
unsharded over model=16).

Specs and meshes are descriptions here (``core.addrspace.PartitionSpec``,
``launch.mesh.Mesh``): the port places nothing by them.
:func:`named_shardings` gives each leaf its sanitized spec and the shape
one device would hold, the counterpart of ``NamedSharding.shard_shape``.
"""

from __future__ import annotations

import math
from typing import Any, Sequence, Tuple

from repro_torch.compat import tree_map
from repro_torch.core.addrspace import PartitionSpec as P

__all__ = ["sanitize", "sanitize_tree", "named_shardings", "shard_shape"]


def _axes_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(mesh.shape[a] for a in entry)
    return mesh.shape[entry]


def sanitize(spec: P, shape: Sequence[int], mesh) -> P:
    """Drop per-dimension axis assignments that don't divide the dim."""
    out = []
    for d, entry in enumerate(tuple(spec)):
        if entry is None or d >= len(shape):
            out.append(entry)
            continue
        size = _axes_size(mesh, entry)
        if size and shape[d] % size == 0:
            out.append(entry)
        elif isinstance(entry, (tuple, list)):
            # try dropping trailing axes until it divides
            cand = list(entry)
            while cand and shape[d] % _axes_size(mesh, tuple(cand)) != 0:
                cand.pop()
            out.append(tuple(cand) if cand else None)
        else:
            out.append(None)
    return P(*out)


def shard_shape(spec: P, shape: Sequence[int], mesh) -> Tuple[int, ...]:
    """The shape one device holds of a ``shape`` tensor laid out by a
    sanitized ``spec`` (every named dimension divides)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(int(n) // _axes_size(mesh, e) for n, e in zip(shape, entries))


def _is_spec(x: Any) -> bool:
    return isinstance(x, P)


def sanitize_tree(spec_tree: Any, struct_tree: Any, mesh) -> Any:
    """sanitize over matching (specs, shapes) trees; a struct leaf is
    anything with a ``.shape`` (a tensor, a ``compat.TensorSpec``)."""
    return tree_map(lambda spec, st: sanitize(spec, st.shape, mesh),
                    spec_tree, struct_tree, is_leaf=_is_spec)


def named_shardings(spec_tree: Any, struct_tree: Any, mesh) -> Any:
    """Specs -> ``(sanitized spec, per-device shape)`` pairs."""

    def one(spec, st):
        s = sanitize(spec, st.shape, mesh)
        return s, shard_shape(s, st.shape, mesh)

    return tree_map(one, spec_tree, struct_tree, is_leaf=_is_spec)
