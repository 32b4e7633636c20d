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
from typing import Any, Callable, Iterator, List, Tuple

import torch

__all__ = [
    "TensorSpec",
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


def tree_flatten_with_path(tree: Any, path: Tuple = ()) -> Iterator[Tuple]:
    """Yield ``(path, leaf)`` in JAX's order: dict keys sorted, sequences
    in order.  A path is the tuple of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_flatten_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from tree_flatten_with_path(x, path + (i,))
    else:
        yield path, tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(skeleton: Any, leaves: List[Any]) -> Any:
    """Rebuild ``skeleton``'s structure with ``leaves`` in flatten order
    (the skeleton's own leaves are ignored)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    out = build(skeleton)
    if next(it, None) is not None:
        raise ValueError("more leaves than the skeleton holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of identical structure."""
    leaves = [tree_leaves(t) for t in (tree,) + rest]
    if any(len(x) != len(leaves[0]) for x in leaves):
        raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])
