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

Split-phase moves (``CommEngine.*_nb``) run these ops on a side stream
(:func:`on_side_stream`).  PyTorch's caching allocator ties a block to
the stream it was allocated on, so the rules, where the tensors are plain
(a vmap ``BatchedTensor`` cannot be recorded), make the reuse safe with
``Tensor.record_stream``: each input, made on the current stream, is
recorded on the side stream, so its block is not handed out again before
the side stream has read it; each output, made on the side stream, is
recorded on the current stream, so its block is not reused by the side
stream before the work queued after the wait has read it.  The rank-
stacked copy ``_stacked`` makes is made and freed on the side stream.

Gradients.  A vmap rule sees plain tensors, so PyTorch's autograd (run
outside ``Context.spmd``: ``loss.backward()`` on a node program's result)
records what the rule computes.  Where a caller needs the gradient, the
rule moves the rank-stacked tensor through ``repro_torch::gas_move``, a
custom op whose ``register_autograd`` holds each move's VJP on the
software transport ("xla"): the VJP of a shift is the reverse shift, of a
permutation the inverse permutation (zeros where a rank received
nothing), of an all-reduce an all-reduce, of an all-gather a
reduce-scatter and back, and an all-to-all is its own.  The GAScore
transport is forward-only, as the reference's Pallas path is (it defines
no VJP): its backward raises.  The VJP runs where autograd runs a
backward, on the stream of its forward, so a split-phase move's VJP
runs on the side stream too.  Without a gradient to record the rule
calls the move directly, as before.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch

from repro_torch.kernels import cost, ops, ref

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

# (side, current) streams while a split-phase move is being enqueued
_STREAMS: List[Tuple[torch.cuda.Stream, torch.cuda.Stream]] = []


@contextlib.contextmanager
def on_side_stream(side: torch.cuda.Stream, current: torch.cuda.Stream):
    """The ops called inside run on ``side`` (the caller made it current)
    on behalf of ``current``: their inputs and outputs are recorded on
    the other stream (see the module's docstring)."""
    _STREAMS.append((side, current))
    try:
        yield
    finally:
        _STREAMS.pop()


def _across(out: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
    if _STREAMS and out.is_cuda:
        side, current = _STREAMS[-1]
        for t in inputs:
            t.record_stream(side)
        out.record_stream(current)
    return out


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


_MOVES = {  # op -> (GAScore kernel, plain version) on the stacked tensor
    "shift": (lambda xs, a: ops.ring_shift(xs, a[0]),
              lambda xs, a: ref.ring_shift(xs, a[0])),
    "permute": (lambda xs, a: ops.perm_put(xs, a),
                lambda xs, a: ref.perm_put(xs, [None if d < 0 else d
                                                for d in a])),
    "all_gather": (lambda xs, a: ops.ring_all_gather(xs),
                   lambda xs, a: ref.all_gather(xs)),
    "reduce_scatter": (lambda xs, a: ops.ring_reduce_scatter(xs),
                       lambda xs, a: ref.reduce_scatter(xs)),
    "all_reduce": (None, lambda xs, a: ref.all_reduce(xs)),
    "all_to_all": (None, lambda xs, a: ref.all_to_all(xs)),
}


def _move_plain(xs: torch.Tensor, op: str, args: List[int],
                backend: str) -> torch.Tensor:
    kernel, plain = _MOVES[op]
    return (kernel if backend == "gascore" else plain)(xs, args)


@torch.library.custom_op("repro_torch::gas_move", mutates_args=())
def _gas_move(xs: torch.Tensor, op: str, args: List[int],
              backend: str) -> torch.Tensor:
    """One transfer on the rank-stacked tensor ``(n, *local)``, with the
    VJP registered below (see the module's docstring)."""
    out = _move_plain(xs, op, args, backend)
    if out.untyped_storage().data_ptr() == xs.untyped_storage().data_ptr():
        out = out.clone()  # a view (all_to_all of one row): not an alias
    return out


def _inverse(dst: List[int]) -> List[int]:
    inv = [-1] * len(dst)
    for s, d in enumerate(dst):
        if d >= 0:
            inv[d] = s
    return inv


_VJPS = {  # op -> (its VJP's op, the VJP's args from the forward's)
    "shift": lambda n, a: ("shift", [(n - a[0]) % n]),
    "permute": lambda n, a: ("permute", _inverse(list(a))),
    "all_reduce": lambda n, a: ("all_reduce", []),
    "all_gather": lambda n, a: ("reduce_scatter", []),
    "reduce_scatter": lambda n, a: ("all_gather", []),
    "all_to_all": lambda n, a: ("all_to_all", []),
}


def _gas_move_setup(ctx, inputs, output):
    xs, ctx.op, ctx.args, ctx.backend = inputs
    ctx.n = xs.shape[0]


def _gas_move_vjp(ctx, grad):
    if ctx.backend == "gascore":
        raise RuntimeError(
            f"the GAScore transport is forward-only: {ctx.op} on backend "
            "'gascore' has no VJP (as the reference's Pallas path defines "
            "none); differentiate through the 'xla' engine"
        )
    op, args = _VJPS[ctx.op](ctx.n, ctx.args)
    return _gas_move(grad, op, args, "xla"), None, None, None


_gas_move.register_autograd(_gas_move_vjp, setup_context=_gas_move_setup)


# op -> (the reference's collective type, result bytes over operand bytes)
_COLLECTIVE = {
    "shift": ("collective-permute", lambda n: 1),
    "permute": ("collective-permute", lambda n: 1),
    "all_gather": ("all-gather", lambda n: n),
    "reduce_scatter": ("reduce-scatter", lambda n: 1 / n),
    "all_reduce": ("all-reduce", lambda n: 1),
    "all_to_all": ("all-to-all", lambda n: 1),
}


def _move(xs: torch.Tensor, op: str, args: List[int], backend: str):
    """The transfer, through ``gas_move`` where autograd records it;
    reported to an active op-stream counter as one collective of the
    reference's type, whatever the backend moves it with."""
    kind, grow = _COLLECTIVE[op]
    operand = xs.numel() * xs.element_size()
    with cost.kernel(f"gas_{op}", 0, operand * (1 + grow(xs.shape[0])),
                     collective=kind, coll_bytes=operand):
        if torch.is_grad_enabled() and xs.requires_grad:
            return _gas_move(xs, op, list(args), backend)
        return _move_plain(xs, op, list(args), backend)


@torch.library.custom_op("repro_torch::gas_shift", mutates_args=())
def shift(x: torch.Tensor, ids: torch.Tensor, k: int, n: int,
          backend: str) -> torch.Tensor:
    """Every rank's ``x`` lands on rank (me + k) % n."""
    _outside("shift")


@shift.register_vmap
def _shift_vmap(info, in_dims, x, ids, k, n, backend):
    xs = _stacked(x, in_dims[0], n)
    return _across(_move(xs, "shift", [k], _backend(backend)), x), 0


@torch.library.custom_op("repro_torch::gas_permute", mutates_args=())
def permute(x: torch.Tensor, ids: torch.Tensor, dst: List[int], n: int,
            backend: str) -> torch.Tensor:
    """Rank i's ``x`` lands on rank ``dst[i]``; -1 sends nowhere, and ranks
    that receive nothing hold zeros (xla only: gascore takes bijections)."""
    _outside("permute")


@permute.register_vmap
def _permute_vmap(info, in_dims, x, ids, dst, n, backend):
    xs = _stacked(x, in_dims[0], n)
    return _across(_move(xs, "permute", dst, _backend(backend)), x), 0


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
    return _across(ops.offset_put(segs, datas, offs, k), seg, data,
                   offset), 0


@torch.library.custom_op("repro_torch::gas_all_gather", mutates_args=())
def all_gather(x: torch.Tensor, ids: torch.Tensor, n: int,
               backend: str) -> torch.Tensor:
    """Local (m, ...) -> the tiled (n*m, ...) concatenation on every rank."""
    _outside("all_gather")


@all_gather.register_vmap
def _all_gather_vmap(info, in_dims, x, ids, n, backend):
    xs = _stacked(x, in_dims[0], n)
    return _across(_move(xs, "all_gather", [], _backend(backend)), x), 0


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
    return _across(_move(xs, "reduce_scatter", [], _backend(backend)), x), 0


@torch.library.custom_op("repro_torch::gas_all_reduce", mutates_args=())
def all_reduce(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``lax.psum`` of the software node: the sum over ranks."""
    _outside("all_reduce")


@all_reduce.register_vmap
def _all_reduce_vmap(info, in_dims, x, ids, n):
    return _across(_move(_stacked(x, in_dims[0], n), "all_reduce", [],
                         "xla"), x), 0


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
    return _across(_move(xs, "all_to_all", [], "xla"), x), 0


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
