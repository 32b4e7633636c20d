"""Int8 error-feedback gradient compression over the GAS ring.

Port of ``repro.optim.compression``.  Each reduce-scatter hop carries int8
payloads plus one f32 scale (4.25 bytes for 4 bytes of f32), dequantizes,
accumulates in f32 and requantizes for the next hop; the all-gather that
follows ships the reduced chunks in int8 too.  Error feedback keeps the
quantization noise from biasing convergence: each node remembers what
quantization destroyed and adds it back next step.

The ring runs inside ``Context.spmd`` on any ``CommEngine``: on "gascore"
every int8 and scale hop is one ``ring_shift`` launch, ``4 (n - 1)`` a
call.  Rounding is the reference's: ``torch.round`` rounds half to even
as ``jnp.round`` does, and the payload is ``x / scale`` (a division, not a
product by ``1 / scale``), so the int8 payloads match bit for bit.

Memory: the arithmetic runs in place on fresh buffers where the
reference's is functional, and the all-gather keeps the n int8 chunks as
they arrive and places them once at the end (chunk ``(me - k) mod n``
arrives at hop k) with one rank-dependent gather, where the reference
updates an f32 output slice by slice; the result is the same bits.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.compat import tree_leaves, tree_unflatten
from repro_torch.core.engine import CommEngine
from repro_torch.core.indexing import take

__all__ = [
    "quantize_int8",
    "dequantize_int8",
    "ef_prepare",
    "compressed_ring_all_reduce",
    "compressed_all_reduce_tree",
    "init_error_state",
]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8 quantization: ``(q, scale)``."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(), min=1e-12) / 127.0
    t = xf / scale
    t.round_()
    t.clamp_min_(-127).clamp_max_(127)  # in place; batched under vmap
    return t.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_prepare(
    g: torch.Tensor, err: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback compensation: compress ``g + err``, remember the
    residual.  Returns ``(q, scale, new_err)``."""
    comp = g.float() + err
    q, s = quantize_int8(comp)
    new_err = comp.sub_(q.float().mul_(s))  # comp - dequantize_int8(q, s)
    return q, s, new_err


def compressed_ring_all_reduce(
    engine: CommEngine, x: torch.Tensor, err: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce (sum) of ``x`` (flat, length divisible by n) with int8
    hops: a ring reduce-scatter that dequantizes, accumulates and
    requantizes at every hop, then an int8 ring all-gather.  Returns
    ``(reduced f32, new error-feedback state)``.  Runs inside
    ``Context.spmd``, ``engine`` the node's."""
    n = engine.n_nodes
    me = engine.my_id()
    L = x.shape[0]
    if L % n:
        raise ValueError(f"length {L} not divisible by {n}")
    m = L // n
    q, s, new_err = ef_prepare(x, err)
    qb = q.reshape(n, m)

    # reduce-scatter: the packet for chunk c starts at node c + 1
    cur_q = take(qb, torch.remainder(me - 1 + n, n))
    cur_s = s
    for h in range(1, n):
        cur_q = engine.shift(cur_q, 1)
        cur_s = engine.shift(cur_s, 1)
        mine = take(qb, torch.remainder(me - h - 1 + 2 * n, n))
        acc = dequantize_int8(cur_q, cur_s) + dequantize_int8(mine, s)
        cur_q, cur_s = quantize_int8(acc)
    del q, qb, acc, mine
    # cur now holds the full sum of chunk ``me``, int8-compressed

    # all-gather of the reduced chunks, int8 on the wire; the chunk that
    # arrives at hop k is chunk (me - k) mod n
    got_q, got_s = [cur_q], [cur_s]
    for _ in range(1, n):
        got_q.append(engine.shift(got_q[-1], 1))
        got_s.append(engine.shift(got_s[-1], 1))
    hop = torch.remainder(me - torch.arange(n, device=x.device), n)
    gq = torch.stack(got_q).index_select(0, hop)
    gs = torch.stack(got_s).index_select(0, hop)
    del got_q, got_s
    out = dequantize_int8(gq, gs[:, None])
    return out.reshape(L), new_err


def compressed_all_reduce_tree(
    engine: CommEngine, grads: Any, err: torch.Tensor
) -> Tuple[Any, torch.Tensor]:
    """Tree version: flatten-concat-pad, one ring, unflatten.  Mean (not
    sum) over nodes, matching data-parallel averaging."""
    leaves = tree_leaves(grads)
    flat = torch.cat([g.reshape(-1).float() for g in leaves])
    n = engine.n_nodes
    pad = (-flat.shape[0]) % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    reduced, new_err = compressed_ring_all_reduce(engine, flat, err)
    reduced = reduced / n
    outs, off = [], 0
    for g in leaves:
        outs.append(reduced[off:off + g.numel()].reshape(g.shape).to(g.dtype))
        off += g.numel()
    return tree_unflatten(grads, outs), new_err


def init_error_state(grads: Any, n_nodes: int) -> torch.Tensor:
    """Zero error-feedback state for ``grads`` flattened and padded to a
    multiple of ``n_nodes``, f32 on the leaves' device."""
    leaves = tree_leaves(grads)
    total = sum(g.numel() for g in leaves)
    total += (-total) % n_nodes
    return torch.zeros((total,), dtype=torch.float32, device=leaves[0].device)
