"""The transport ops of the GAS layer, lifted over the rank axis.

Inside ``Context.spmd`` a node program runs under ``torch.func.vmap`` over
the ranks (the port's ``shard_map``).  A transfer between ranks cannot be
written per rank, so each transport op is a ``torch.library.custom_op``
whose vmap rule receives the RANK-STACKED tensor ``(n, *local)`` and moves
the data of all n ranks in one call:

- ``backend="xla"``     — the software node: PyTorch indexing (the plain
  versions of ``repro_torch.kernels.ref``), the counterpart of
  ``lax.ppermute`` / ``lax.all_gather`` / ``lax.psum``;
- ``backend="gascore"`` — the hardware node: ``repro_torch.kernels.ops``,
  i.e. ONE launch of the hand-written CUDA kernel for a CUDA tensor (its
  plain version for a CPU tensor).

Every op takes the batched rank ids ``ids`` (``node.my_id``), so its vmap
rule always fires; called outside vmap an op raises.  Unbatched operands
(a constant every rank sends) are expanded to n copies first.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch.kernels import ops, ref

__all__ = [
    "shift",
    "permute",
    "offset_put",
    "all_gather",
    "reduce_scatter",
    "all_reduce",
    "all_to_all",
    "bitcast",
]

BACKENDS = ("xla", "gascore")


def _outside(name: str):
    raise RuntimeError(
        f"transport op {name} must run inside Context.spmd (under vmap "
        "over the rank axis)"
    )


def _stacked(x: torch.Tensor, dim, n: int) -> torch.Tensor:
    """The rank-stacked (n, *local) view of a vmapped operand."""
    if dim is None:
        return x.unsqueeze(0).expand((n,) + tuple(x.shape)).contiguous()
    return x.movedim(dim, 0).contiguous()


def _backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown transport backend {backend!r}")
    return backend


@torch.library.custom_op("repro_torch::gas_shift", mutates_args=())
def shift(x: torch.Tensor, ids: torch.Tensor, k: int, n: int,
          backend: str) -> torch.Tensor:
    """Every rank's ``x`` lands on rank (me + k) % n."""
    _outside("shift")


@shift.register_vmap
def _shift_vmap(info, in_dims, x, ids, k, n, backend):
    xs = _stacked(x, in_dims[0], n)
    if _backend(backend) == "gascore":
        return ops.ring_shift(xs, k), 0
    return ref.ring_shift(xs, k), 0


@torch.library.custom_op("repro_torch::gas_permute", mutates_args=())
def permute(x: torch.Tensor, ids: torch.Tensor, dst: List[int], n: int,
            backend: str) -> torch.Tensor:
    """Rank i's ``x`` lands on rank ``dst[i]``; -1 sends nowhere, and ranks
    that receive nothing hold zeros (xla only: gascore takes bijections)."""
    _outside("permute")


@permute.register_vmap
def _permute_vmap(info, in_dims, x, ids, dst, n, backend):
    xs = _stacked(x, in_dims[0], n)
    if _backend(backend) == "gascore":
        return ops.perm_put(xs, dst), 0
    return ref.perm_put(xs, [None if d < 0 else d for d in dst]), 0


@torch.library.custom_op("repro_torch::gas_offset_put", mutates_args=())
def offset_put(seg: torch.Tensor, data: torch.Tensor, offset: torch.Tensor,
               ids: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """AMLong through the GAScore: ``data`` lands in rank (me + k) % n's
    partition of ``seg`` at the sender's leading ``offset``; returns the
    updated segment."""
    _outside("offset_put")


@offset_put.register_vmap
def _offset_put_vmap(info, in_dims, seg, data, offset, ids, k, n):
    segs = _stacked(seg, in_dims[0], n)
    if in_dims[0] is not None:
        # the op is functional; the kernel writes in place into a copy (as
        # XLA copies a non-donated buffer aliased to a kernel's output)
        segs = segs.clone()
    datas = _stacked(data, in_dims[1], n)
    offs = _stacked(offset.to(torch.int32), in_dims[2], n)
    return ops.offset_put(segs, datas, offs, k), 0


@torch.library.custom_op("repro_torch::gas_all_gather", mutates_args=())
def all_gather(x: torch.Tensor, ids: torch.Tensor, n: int,
               backend: str) -> torch.Tensor:
    """Local (m, ...) -> the tiled (n*m, ...) concatenation on every rank."""
    _outside("all_gather")


@all_gather.register_vmap
def _all_gather_vmap(info, in_dims, x, ids, n, backend):
    xs = _stacked(x, in_dims[0], n)
    if _backend(backend) == "gascore":
        return ops.ring_all_gather(xs), 0
    return ref.all_gather(xs), 0


@torch.library.custom_op("repro_torch::gas_reduce_scatter", mutates_args=())
def reduce_scatter(x: torch.Tensor, ids: torch.Tensor, n: int,
                   backend: str) -> torch.Tensor:
    """(n*m, ...) -> this rank's summed chunk (m, ...), in ring order."""
    _outside("reduce_scatter")


@reduce_scatter.register_vmap
def _reduce_scatter_vmap(info, in_dims, x, ids, n, backend):
    xs = _stacked(x, in_dims[0], n)
    if xs.dim() < 2 or xs.shape[1] % n:
        raise ValueError(f"reduce_scatter dim0 {tuple(xs.shape[1:])} not "
                         f"divisible by {n}")
    if _backend(backend) == "gascore":
        return ops.ring_reduce_scatter(xs), 0
    return ref.reduce_scatter(xs), 0


@torch.library.custom_op("repro_torch::gas_all_reduce", mutates_args=())
def all_reduce(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``lax.psum`` of the software node: the sum over ranks."""
    _outside("all_reduce")


@all_reduce.register_vmap
def _all_reduce_vmap(info, in_dims, x, ids, n):
    return ref.all_reduce(_stacked(x, in_dims[0], n)), 0


@torch.library.custom_op("repro_torch::gas_all_to_all", mutates_args=())
def all_to_all(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``lax.all_to_all`` (tiled) of the software node."""
    _outside("all_to_all")


@all_to_all.register_vmap
def _all_to_all_vmap(info, in_dims, x, ids, n):
    xs = _stacked(x, in_dims[0], n)
    if xs.dim() < 2 or xs.shape[1] % n:
        raise ValueError(f"all_to_all dim0 {tuple(xs.shape[1:])} not "
                         f"divisible by {n}")
    return ref.all_to_all(xs), 0


@torch.library.custom_op("repro_torch::gas_bitcast", mutates_args=())
def bitcast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x``'s bits as ``dtype`` of the same width (a copy): the vectored
    put's int32 command block riding its float32 payload carrier.  Under
    vmap too, where ``Tensor.view(dtype)`` has no batching rule in every
    PyTorch release; outside vmap it is the plain bitcast."""
    return x.view(dtype).clone()


@bitcast.register_vmap
def _bitcast_vmap(info, in_dims, x, dtype):
    return x.view(dtype).clone(), in_dims[0]
