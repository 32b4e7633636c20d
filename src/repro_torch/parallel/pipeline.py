"""Pipeline parallelism over the rank axis (GPipe fill-drain).

Port of ``repro.parallel.pipeline``.  A stage is a shard of the stacked
layer dimension, one per rank.  ``gpipe`` runs inside ``Context.spmd``
(the port's ``shard_map``); stage boundaries are split-phase one-sided
neighbour puts through a :class:`~repro_torch.core.engine.CommEngine`
(``engine.permute_nb`` / ``engine.shift_nb``): the activation put to
stage s+1 is initiated as soon as the stage body finishes, and the
output bookkeeping of the current tick runs while it is in flight.

Gradients: ``loss.backward()`` outside ``Context.spmd`` reaches through
the node program, because every transport op records its VJP (the
reverse move on the software transport, see ``core/transport.py``).  The
GAScore transport is forward-only, as in the reference, where the Pallas
path defines no VJP: its backward raises.

Schedule (S stages, M microbatches, T = M + S - 1 ticks):

  tick t: stage s computes microbatch (t - s) if 0 <= t - s < M,
          then puts its activation to stage s+1.

Bubble fraction = (S-1)/T, the standard GPipe overhead.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Optional

import torch

from repro_torch.compat import tree_leaves, tree_unflatten
from repro_torch.core import gasnet, sched
from repro_torch.core.collectives import segment_bounds
from repro_torch.core.engine import CommEngine, Pending, wait_all
from repro_torch.core.gasnet import P
from repro_torch.core.indexing import dynamic_update_slice

__all__ = ["gpipe", "pipelined", "remat_stage"]


def gpipe(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x_micro: torch.Tensor,  # (M, mb, ...) microbatched input (stage 0's)
    *,
    engine: CommEngine,
    n_stages: int,
    broadcast_out: bool = True,
    boundary_segments: Optional[int] = None,
) -> torch.Tensor:
    """Run ``stage_fn`` as a GPipe pipeline inside ``Context.spmd``.

    Every rank holds ``stage_params`` for ITS stage; ``engine`` is the
    node's (``node.engine``), the stage-boundary transport.  Returns the
    final stage's outputs (M, mb, ...); with ``broadcast_out`` they are
    summed over the ranks by the engine's all-reduce (only the last stage
    is nonzero), so every stage holds them, otherwise they are valid on
    the last stage only.

    On engines with partial permutes (``engine.can_permute_partial``)
    the boundary put is a chain permute (s -> s+1, none from the last
    stage); bijection-only transports (GAScore) use a ring ``shift(1)``
    whose wrap edge (S-1 -> 0) is dead: stage 0 always injects a fresh
    microbatch.  ``boundary_segments`` (default: planned by
    ``sched.plan_p2p`` from the activation bytes) splits each put into
    that many puts in flight.
    """
    S = n_stages
    M = x_micro.shape[0]
    eng = engine
    chain = list(range(1, S)) + [None]  # s -> s+1, the last sends nowhere
    use_chain = eng.can_permute_partial
    if boundary_segments is None:
        mb_bytes = math.prod(x_micro.shape[1:]) * x_micro.element_size()
        boundary_segments = sched.plan_p2p(nbytes=mb_bytes,
                                           engine=eng).n_segments
    n_seg = max(1, int(boundary_segments))

    def one_put_nb(y: torch.Tensor) -> Pending:
        return eng.permute_nb(y, chain) if use_chain else eng.shift_nb(y, 1)

    def boundary_put_nb(y: torch.Tensor) -> List[Pending]:
        """Initiate the stage-boundary put as n_seg puts in flight."""
        if n_seg == 1 or y.dim() == 0 or y.shape[0] < n_seg:
            return [one_put_nb(y)]
        return [one_put_nb(y[lo:hi])
                for lo, hi in segment_bounds(y.shape[0], n_seg)]

    def boundary_wait(pendings: List[Pending]) -> torch.Tensor:
        parts = wait_all(pendings)
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)

    stage = eng.my_id()
    carry_in = torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype,
                           device=x_micro.device)
    outputs = torch.zeros_like(x_micro)
    last = stage == S - 1
    for t in range(M + S - 1):
        # stage 0 injects microbatch t; the others consume the neighbour put
        mb_idx = torch.clamp(t - stage, 0, M - 1)
        inject = x_micro[min(t, M - 1)]
        x_in = torch.where(stage == 0, inject, carry_in)
        active = (t - stage >= 0) & (t - stage < M)
        y = stage_fn(stage_params, x_in)
        y = torch.where(active, y, torch.zeros_like(y))
        # split-phase put to the next stage: initiated as soon as y exists,
        # the outputs recorded while the transfer is in flight
        pendings = boundary_put_nb(y)
        outputs = torch.where(active & last,
                              dynamic_update_slice(outputs, y[None], mb_idx),
                              outputs)
        carry_in = boundary_wait(pendings)
    if broadcast_out:
        outputs = eng.all_reduce(outputs)  # only the last stage is nonzero
    return outputs


class _Remat(torch.autograd.Function):
    """Keep a stage's inputs, recompute its forward in the backward (the
    reference's ``jax.checkpoint``).  ``torch.utils.checkpoint`` cannot
    run under the rank vmap (its recompute would replay the batched
    inputs after the vmap has exited), so this Function, which vmap
    lifts with the rest of the node program, recomputes through
    ``torch.func.vjp``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, grad):
        _, vjp = torch.func.vjp(ctx.fn, *ctx.saved_tensors)
        return (None,) + tuple(vjp(grad))


def remat_stage(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor]
) -> Callable:
    """``stage_fn(params, x)`` that saves only its inputs for the backward
    and recomputes the rest there."""

    def body(params, x):
        leaves = tree_leaves(params)

        def flat(*ts):
            return stage_fn(tree_unflatten(params, list(ts[:-1])), ts[-1])

        return _Remat.apply(flat, *leaves, x)

    return body


def pipelined(
    stage_fn: Callable,
    *,
    ctx: gasnet.Context,
    n_micro: int,
    remat: bool = True,
    boundary_segments: Optional[int] = None,
) -> Callable:
    """A pipelined forward ``fn(stage_params, x_micro)`` over ``ctx``'s
    ranks, one stage a rank (the reference's ``pipelined`` over a mesh
    axis).  ``stage_params`` is stacked on a leading stage axis of
    ``ctx.n_nodes`` (rank s gets slice s, of leading length 1);
    ``x_micro`` (``n_micro``, mb, ...) is replicated, and so is the
    result.  ``ctx.backend`` selects the stage-boundary transport,
    ``boundary_segments`` its segmentation (default: planned, see
    :func:`gpipe`); ``remat`` recomputes each stage in the backward."""
    n_stages = ctx.n_nodes
    body = remat_stage(stage_fn) if remat else stage_fn

    def program(node, stage_params, x_micro):
        if x_micro.shape[0] != n_micro:
            raise ValueError(f"{x_micro.shape[0]} microbatches, expected "
                             f"{n_micro}")
        return gpipe(body, stage_params, x_micro, engine=node.engine,
                     n_stages=n_stages, boundary_segments=boundary_segments)

    def fn(stage_params, x_micro):
        return ctx.spmd(program, stage_params, x_micro,
                        in_specs=(P(ctx.node_axis), P()), out_specs=P())

    return fn
