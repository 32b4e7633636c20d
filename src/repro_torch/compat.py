"""Small shared helpers: device resolution and nested-dict pytrees.

The reference leans on ``jax.tree_util`` for every cache and parameter
tree.  The port keeps the same trees (nested dicts, lists and tuples of
tensors) and needs the one property that layouts depend on: dicts
flatten in SORTED key order, exactly as JAX flattens them, so a cache
``{"k", "pos", "v"}`` lays its carrier columns out as k, pos, v in both
packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch

__all__ = [
    "TensorSpec",
    "device_const",
    "resolve_device",
    "tree_flatten_with_path",
    "tree_leaves",
    "tree_map",
    "tree_unflatten",
]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a tensor that is not allocated (the port's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another one.  Raises when CUDA is asked for and absent, so a run
    never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


# (values, dtype, device) -> the device tensor holding them
_CONSTS: dict = {}


def _materialize(values: Tuple, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def device_const(values: Any, dtype: torch.dtype, device: Any) -> torch.Tensor:
    """A small constant (an index list, a mask) as a tensor on ``device``,
    built once per ``(values, dtype, device)`` and shared after.  A
    ``torch.tensor(..., device="cuda")`` of host values copies them from
    pageable memory, and that copy makes the host wait for the stream to
    drain; the cached tensor is copied once.  Callers never write to it.
    The cache is never evicted, so its keys must come from a bounded set:
    permutations of a group's ranks and their masks, not caller-chosen
    index lists (``indexing.as_i32`` stages those through pinned memory)."""
    dev = torch.device(device)
    key = (tuple(values), dtype, dev)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = _materialize(key[0], dtype, dev)
    return t


def tree_flatten_with_path(tree: Any, path: Tuple = (),
                           is_leaf: Optional[Callable[[Any], bool]] = None
                           ) -> Iterator[Tuple]:
    """Yield ``(path, leaf)`` in JAX's order: dict keys sorted, sequences
    in order.  A path is the tuple of keys and indices down to the leaf.
    ``is_leaf(node)`` True stops the descent there (a ``PartitionSpec``
    is a tuple)."""
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_flatten_with_path(tree[k], path + (k,), is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from tree_flatten_with_path(x, path + (i,), is_leaf)
    else:
        yield path, tree


def tree_leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
                ) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree, (), is_leaf)]


def tree_unflatten(skeleton: Any, leaves: List[Any],
                   is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """Rebuild ``skeleton``'s structure with ``leaves`` in flatten order
    (the skeleton's own leaves are ignored)."""
    it = iter(leaves)

    def build(node):
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(skeleton)
    if next(it, None) is not None:
        raise ValueError("more leaves than the skeleton holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """Apply ``fn`` leafwise over trees of identical structure (that of
    ``tree``: the others are flattened as deep as it is)."""
    leaves = [tree_leaves(tree, is_leaf)]
    for t in rest:
        leaves.append([x for _, x in _flatten_like(tree, t, is_leaf)])
    if any(len(x) != len(leaves[0]) for x in leaves):
        raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)], is_leaf)


def _flatten_like(skeleton: Any, tree: Any, is_leaf) -> Iterator[Tuple]:
    """``tree``'s nodes at the leaves of ``skeleton``."""
    if is_leaf is None:
        yield from tree_flatten_with_path(tree)
        return
    for path, _ in tree_flatten_with_path(skeleton, (), is_leaf):
        node = tree
        for key in path:
            node = node[key]
        yield path, node
