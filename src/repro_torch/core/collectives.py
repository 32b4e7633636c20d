"""Ring collectives built from one-sided puts (port of ``repro.core.collectives``).

The paper's GAScore gives nodes one-sided remote writes; classic PGAS
collectives are then *algorithms over puts*.  These implementations take a
:class:`~repro_torch.core.engine.CommEngine`, so the same algorithm runs on
the software node (indexing transport) or the hardware node (the CUDA copy
kernels) — engine parity is tested, bit for bit, against the reference.

All rings are built on the split-phase primitives (``engine.shift_nb`` →
``Pending.wait``): each hop's put is initiated *before* the local work of
the previous hop, the double-buffered schedule a GAScore drains from its
command FIFO.  On the card the put runs on the engine's side stream, so
in the segmented rings segment k+1's copy runs beside segment k's
epilogue (its add or store) on the current stream.

Every function runs per rank inside ``Context.spmd`` (or the lockstep
simulator); rank-dependent slices go through ``core.indexing``.

- :func:`ring_all_gather`     local (m, ...)        -> (n*m, ...)
- :func:`ring_reduce_scatter` (n*m, ...)            -> summed (m, ...)
- :func:`ring_all_reduce`     (n*m, ...)            -> summed (n*m, ...)
- :func:`broadcast`           root's (m, ...)       -> same on every node
- :func:`exchange`            (n*m, ...)            -> all-to-all, all n-1
  puts in flight at once
- :func:`segmented_ring_all_gather` / ``_reduce_scatter`` / ``_all_reduce``:
  the payload in ``n_segments`` slices with up to ``depth`` puts in flight,
  bit-identical to the monolithic rings.
- :func:`recursive_doubling_all_reduce`, :func:`tree_broadcast`: the
  latency-optimal tier.
- :func:`hierarchical_all_reduce`: RS inside each pod, AR across pods, AG
  inside each pod.  ``Context.spmd`` lifts programs over one rank axis,
  so the reference's two mesh axes are two group engines over it
  (``engine.pod_engines``).
"""

from __future__ import annotations

import math
from collections import deque
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core.engine import CommEngine
from repro_torch.core.indexing import dynamic_update_slice, take

__all__ = [
    "ring_all_gather",
    "ring_reduce_scatter",
    "ring_all_reduce",
    "segmented_ring_all_gather",
    "segmented_ring_reduce_scatter",
    "segmented_ring_all_reduce",
    "recursive_doubling_all_reduce",
    "tree_broadcast",
    "hierarchical_all_reduce",
    "broadcast",
    "exchange",
    "ring_all_to_all",
    "segment_bounds",
]


def _rem(me: torch.Tensor, n: int) -> torch.Tensor:
    return torch.remainder(me, n)


def ring_all_gather(engine: CommEngine, x: torch.Tensor) -> torch.Tensor:
    """All-gather via n-1 neighbor puts.

    Round k: every node puts the chunk it received in round k-1 to its right
    neighbor.  The hop-(k+1) put of a received chunk is initiated *before*
    that chunk is stored into the local output slot.
    """
    n = engine.n_nodes
    me = engine.my_id()
    out = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    out = dynamic_update_slice(out, x[None], me)
    pending = engine.shift_nb(x, 1)  # hop 1 in flight before any local work
    for k in range(1, n):
        cur = pending.wait()
        if k < n - 1:
            pending = engine.shift_nb(cur, 1)  # forward before storing
        src = _rem(me - k + n, n)
        out = dynamic_update_slice(out, cur[None], src)
    if x.dim():
        return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    return out


def ring_reduce_scatter(engine: CommEngine, x: torch.Tensor) -> torch.Tensor:
    """Reduce-scatter via n-1 put+accumulate hops.

    The packet for chunk ``c`` starts at node ``c+1`` (with that node's
    contribution to chunk c), travels the ring by one-sided puts to the
    right neighbor, and each visited node accumulates its own contribution.
    After ``n-1`` hops node ``me`` holds the packet for its own chunk.
    """
    n = engine.n_nodes
    if x.shape[0] % n != 0:
        raise ValueError(f"reduce_scatter dim0 {x.shape[0]} not divisible by {n}")
    m = x.shape[0] // n
    blocks = x.reshape((n, m) + tuple(x.shape[1:]))
    me = engine.my_id()
    # packet leaving me is for chunk (me - 1) mod n; seed with my contribution
    cur = take(blocks, _rem(me - 1 + n, n))
    for h in range(1, n):
        pending = engine.shift_nb(cur, 1)  # put partial sum to right neighbor
        c = _rem(me - h - 1 + 2 * n, n)  # chunk id of the incoming packet
        mine = take(blocks, c)
        cur = pending.wait() + mine
    return cur


def ring_all_reduce(engine: CommEngine, x: torch.Tensor) -> torch.Tensor:
    """All-reduce = reduce-scatter + all-gather (2·(n-1) hops of size S/n)."""
    n = engine.n_nodes
    if x.dim() and x.shape[0] % n == 0 and x.shape[0] > 0:
        return ring_all_gather(engine, ring_reduce_scatter(engine, x))
    # fallback: shift-accumulate ring with full payload per hop
    acc = x
    cur = x
    for _ in range(n - 1):
        cur = engine.shift(cur, 1)
        acc = acc + cur
    return acc


def broadcast(engine: CommEngine, x: torch.Tensor, *, root: int = 0) -> torch.Tensor:
    """Broadcast the root node's ``x`` to every node (ring pipeline).

    Every node forwards what it received on the previous hop; node
    ``(root + k) % n`` receives the root's value at hop ``k`` and selects
    it into its output.
    """
    n = engine.n_nodes
    if n == 1:
        return x
    me = engine.my_id()
    out = x  # root already holds its own value; others get overwritten
    cur = x
    pending = engine.shift_nb(cur, 1)
    for k in range(1, n):
        cur = pending.wait()
        if k < n - 1:
            pending = engine.shift_nb(cur, 1)  # forward before selecting
        out = torch.where(me == (root + k) % n, cur, out)
    return out


def exchange(engine: CommEngine, x: torch.Tensor) -> torch.Tensor:
    """All-to-all personalized exchange built from non-blocking puts.

    Viewing (n*m, ...) as n blocks, block ``d`` of node ``s`` lands as
    block ``s`` of node ``d``.  All n-1 one-sided puts (block for node
    ``me+k`` travels as one distance-k put) are initiated before any
    completion is consumed.
    """
    n = engine.n_nodes
    if x.shape[0] % n != 0:
        raise ValueError(f"exchange dim0 {x.shape[0]} not divisible by {n}")
    m = x.shape[0] // n
    blocks = x.reshape((n, m) + tuple(x.shape[1:]))
    me = engine.my_id()
    out = torch.zeros_like(blocks)
    own = take(blocks, me)
    out = dynamic_update_slice(out, own[None], me)
    pendings = []
    for k in range(1, n):
        send = take(blocks, _rem(me + k, n))
        pendings.append((k, engine.shift_nb(send, k)))  # initiate all
    for k, p in pendings:  # then drain completions
        recv = p.wait()
        src = _rem(me - k + n, n)
        out = dynamic_update_slice(out, recv[None], src)
    return out.reshape(x.shape)


def ring_all_to_all(engine: CommEngine, x: torch.Tensor) -> torch.Tensor:
    """All-to-all over the engine's transport (see CommEngine.all_to_all)."""
    return engine.all_to_all(x)


# --------------------------------------------------------------------------- #
# Segmented / pipelined rings
# --------------------------------------------------------------------------- #
def segment_bounds(m: int, n_segments: int) -> List[Tuple[int, int]]:
    """Contiguous ``[lo, hi)`` slices splitting ``m`` rows into at most
    ``n_segments`` near-equal segments (first remainder segments one larger,
    like ``np.array_split``)."""
    g = max(1, min(int(n_segments), m))
    base, rem = divmod(m, g)
    bounds = []
    lo = 0
    for i in range(g):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _drain_pipeline(states: List[dict], depth: int, step: Callable) -> None:
    """Software pipeline over per-segment ring state machines.

    At most ``depth`` segments have a put in flight at any point; segments
    are serviced round-robin FIFO.  ``step(st)`` waits st's pending, runs
    the epilogue, initiates the next hop, and returns False once the
    segment retired.
    """
    depth = max(1, int(depth))
    inflight: deque = deque()
    pending_start = deque(states)
    while pending_start and len(inflight) < depth:
        st = pending_start.popleft()
        st["start"](st)
        inflight.append(st)
    while inflight:
        st = inflight.popleft()
        if step(st):
            inflight.append(st)
        elif pending_start:
            nxt = pending_start.popleft()
            nxt["start"](nxt)
            inflight.append(nxt)


def segmented_ring_all_gather(
    engine: CommEngine, x: torch.Tensor, *, n_segments: int = 1, depth: int = 2
) -> torch.Tensor:
    """:func:`ring_all_gather`, payload chunked into ``n_segments`` slices
    with up to ``depth`` puts in flight; bit-identical to the monolithic
    call."""
    n = engine.n_nodes
    if x.dim() == 0 or n_segments <= 1 or x.shape[0] < 2 or n == 1:
        return ring_all_gather(engine, x)
    m = x.shape[0]
    me = engine.my_id()
    bounds = segment_bounds(m, n_segments)
    if len(bounds) == 1:
        return ring_all_gather(engine, x)

    def start(st):
        seg = x[st["lo"] : st["hi"]]
        out = torch.zeros((n,) + tuple(seg.shape), dtype=seg.dtype,
                          device=seg.device)
        st["out"] = dynamic_update_slice(out, seg[None], me)
        st["pending"] = engine.shift_nb(seg, 1)
        st["k"] = 1

    def step(st):
        cur = st["pending"].wait()
        k = st["k"]
        alive = k < n - 1
        if alive:
            st["pending"] = engine.shift_nb(cur, 1)  # forward before storing
        src = _rem(me - k + n, n)
        st["out"] = dynamic_update_slice(st["out"], cur[None], src)
        st["k"] = k + 1
        return alive

    states = [dict(lo=lo, hi=hi, start=start) for lo, hi in bounds]
    _drain_pipeline(states, depth, step)
    # stitch segments back: (n, m_g, ...) concat over the row axis
    full = torch.cat([st["out"] for st in states], dim=1)
    return full.reshape((n * m,) + tuple(x.shape[1:]))


def segmented_ring_reduce_scatter(
    engine: CommEngine, x: torch.Tensor, *, n_segments: int = 1, depth: int = 2
) -> torch.Tensor:
    """:func:`ring_reduce_scatter`, payload chunked into ``n_segments``
    slices with up to ``depth`` put+accumulate pipelines in flight; per
    segment the hop and accumulation order are the monolithic ring's, so
    results are bit-identical (floats too)."""
    n = engine.n_nodes
    if x.shape[0] % n != 0:
        raise ValueError(f"reduce_scatter dim0 {x.shape[0]} not divisible by {n}")
    m = x.shape[0] // n
    if n_segments <= 1 or m < 2 or n == 1:
        return ring_reduce_scatter(engine, x)
    bounds = segment_bounds(m, n_segments)
    if len(bounds) == 1:
        return ring_reduce_scatter(engine, x)
    blocks = x.reshape((n, m) + tuple(x.shape[1:]))
    me = engine.my_id()

    def start(st):
        seg_blocks = blocks[:, st["lo"] : st["hi"]]
        st["blocks"] = seg_blocks  # (n, m_g, ...)
        cur = take(seg_blocks, _rem(me - 1 + n, n))
        st["pending"] = engine.shift_nb(cur, 1)
        st["h"] = 1

    def step(st):
        h = st["h"]
        c = _rem(me - h - 1 + 2 * n, n)
        mine = take(st["blocks"], c)
        cur = st["pending"].wait() + mine
        alive = h < n - 1
        if alive:
            st["pending"] = engine.shift_nb(cur, 1)
        else:
            st["cur"] = cur
        st["h"] = h + 1
        return alive

    states = [dict(lo=lo, hi=hi, start=start) for lo, hi in bounds]
    _drain_pipeline(states, depth, step)
    return torch.cat([st["cur"] for st in states], dim=0)


def segmented_ring_all_reduce(
    engine: CommEngine, x: torch.Tensor, *, n_segments: int = 1, depth: int = 2
) -> torch.Tensor:
    """Segmented :func:`ring_all_reduce` (RS + AG, both pipelined);
    bit-identical to the monolithic call for any ``n_segments``/``depth``."""
    n = engine.n_nodes
    if x.dim() and x.shape[0] % n == 0 and x.shape[0] > 0:
        shard = segmented_ring_reduce_scatter(
            engine, x, n_segments=n_segments, depth=depth
        )
        return segmented_ring_all_gather(
            engine, shard, n_segments=n_segments, depth=depth
        )
    return ring_all_reduce(engine, x)


# --------------------------------------------------------------------------- #
# Latency-optimal algorithms (the scheduler's small-payload tier)
# --------------------------------------------------------------------------- #
def recursive_doubling_all_reduce(engine: CommEngine, x: torch.Tensor) -> torch.Tensor:
    """All-reduce in log2(n) pairwise-exchange rounds (full payload each).

    Round r exchanges with the partner at XOR distance 2^r — a bijection,
    so it runs on every engine.  Requires power-of-two n.
    """
    n = engine.n_nodes
    if n & (n - 1):
        raise ValueError(f"recursive doubling needs power-of-two nodes, got {n}")
    cur = x
    d = 1
    while d < n:
        dst = [i ^ d for i in range(n)]
        pending = engine.permute_nb(cur, dst)
        cur = cur + pending.wait()
        d *= 2
    return cur


def tree_broadcast(
    engine: CommEngine, x: torch.Tensor, *, root: int = 0
) -> torch.Tensor:
    """Binomial-tree broadcast: ceil(log2 n) rounds instead of n-1 hops.

    Round r: ranks (relative to root) in [0, 2^r) send to rank+2^r.  The
    send set is partial, so this needs ``engine.can_permute_partial``."""
    n = engine.n_nodes
    if n == 1:
        return x
    if not engine.can_permute_partial:
        raise ValueError(
            f"tree_broadcast needs partial permute; engine {engine.name!r} "
            "only supports bijections (use broadcast())"
        )
    me = engine.my_id()
    rel = _rem(me - root + n, n)
    out = x
    rounds = max(1, math.ceil(math.log2(n)))
    for r in range(rounds):
        span = 1 << r
        dst = [None] * n
        for i in range(n):
            i_rel = (i - root) % n
            if i_rel < span and i_rel + span < n:
                dst[i] = (i + span) % n
        pending = engine.permute_nb(out, dst)
        recv = pending.wait()
        is_recv = (rel >= span) & (rel < 2 * span)
        out = torch.where(is_recv, recv, out)
    return out


def hierarchical_all_reduce(
    inner: CommEngine,
    outer: CommEngine,
    x: torch.Tensor,
    all_reduce_outer: Optional[
        Callable[[CommEngine, torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Pod-aware all-reduce: RS(inner) -> AR(outer) -> AG(inner).

    ``inner`` enumerates nodes inside a pod (cheap on-chip-network links),
    ``outer`` enumerates pods (expensive OCCC links); on the port both are
    group engines over the one rank axis (``engine.pod_engines``).  Only
    1/n_inner of the data crosses the outer axis.
    """
    ar = all_reduce_outer or ring_all_reduce
    shard = ring_reduce_scatter(inner, x)
    shard = ar(outer, shard)
    return ring_all_gather(inner, shard)
