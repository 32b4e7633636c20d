"""Memory tier of the port: host-side page slots for swapped-out KV pages.

Counterpart of ``repro.serving.tier``, bookkeeping half.  When the decode
pool oversubscribes, preemption victims' pages *swap out* to the tier and
*swap in* again at resume, bit-exactly.  :class:`MemoryTier` keeps a
slot allocator per memory rank (LIFO free lists, mirroring the pool
allocator) plus per-request holdings mapping each swapped request's
logical pages to ``(memory_rank, slot)`` addresses, with optional replica
legs on distinct ranks.  With ``host_backed=True`` (the colocated server)
the slot arrays are host memory and swap bytes move without a wire.

:func:`check_tier` extends the pool invariant across the hierarchy: a
request is resident in exactly one tier, tier slots are never leaked or
double-freed on any LIVE rank, and a drained tier holds nothing.

In the disaggregated cluster the slots are the memory ranks' GASNet
segments and the bytes move only over the wire: :func:`swap_out_pages`
is one vectored put of m victim pages plus their tier-slot offsets in
one command block (``Node.put_nbv``), and a swap-in is one vectored get
(``pool.fetch_pages``) landed by :func:`install_pages`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import sched
from repro_torch.core.indexing import as_i32, dynamic_slice, dynamic_update_slice
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import Registry, counter_property
from repro_torch.serving.kv import segment_bounds

__all__ = [
    "TierError",
    "OutOfSlotsError",
    "Placement",
    "Holding",
    "MemoryTier",
    "check_tier",
    "swap_out_pages",
    "install_pages",
]


class TierError(RuntimeError):
    """Base memory-tier bookkeeping error."""


class OutOfSlotsError(TierError):
    """No memory rank has enough free slots for a swap-out."""


@dataclasses.dataclass(frozen=True)
class Placement:
    """One replica leg of a holding: logical page ``i`` of the request
    lives in slot ``slots[i]`` of memory rank ``rank``."""

    rank: int  # memory pool index (0-based over the memory ranks)
    slots: Tuple[int, ...]  # tier slot per logical page

    @property
    def n_pages(self) -> int:
        return len(self.slots)


@dataclasses.dataclass(frozen=True)
class Holding:
    """One swapped-out request's tier residency.  ``rank``/``slots`` name
    the primary placement (kept flat for the single-replica fast path);
    ``replicas`` carries the extra legs the fanned swap-out also fed."""

    rank: int  # primary memory pool index
    logical: Tuple[int, ...]  # logical page ids, ascending
    slots: Tuple[int, ...]  # tier slot per logical page (primary)
    replicas: Tuple[Placement, ...] = ()

    @property
    def placements(self) -> Tuple[Placement, ...]:
        """Every live-or-dead leg, primary first."""
        return (Placement(self.rank, self.slots),) + self.replicas


class MemoryTier:
    """Host bookkeeping of the memory ranks' page slots.

    ``n_ranks`` memory ranks export ``slots_per_rank`` page slots of
    ``page_elems`` carrier elements each.  ``host_backed=True`` (the
    colocated server) additionally materialises the slot arrays host-side
    so swap bytes can move without a wire; the disaggregated cluster
    leaves ``host_mem`` empty and moves bytes one-sided between GASNet
    segments.  ``replicas`` is the default placement fan-out of
    :meth:`plan_swap_out`: each swap-out allocates slots on up to that
    many distinct live ranks, and restores survive ``replicas - 1``
    memory-rank losses.

    Cumulative counters live on a typed
    :class:`~repro_torch.obs.metrics.Registry` (pass ``registry`` to share the
    owning cluster's); ``stats()`` keys are unchanged.
    """

    # cumulative counters, registry-backed (explicit Counter kind)
    swapped_out_pages = counter_property("tier_swapped_out_pages")
    swapped_in_pages = counter_property("tier_swapped_in_pages")
    replica_pages = counter_property("tier_replica_pages")
    quorum_restores = counter_property("tier_quorum_restores")
    degraded_placements = counter_property("tier_degraded_placements")

    def __init__(
        self,
        n_ranks: int,
        slots_per_rank: int,
        page_elems: int,
        host_backed: bool = False,
        replicas: int = 1,
        registry: Optional[Registry] = None,
    ):
        if n_ranks < 1 or slots_per_rank < 1:
            raise ValueError(
                f"memory tier needs >= 1 rank and slot, got "
                f"{n_ranks}x{slots_per_rank}"
            )
        if not (1 <= replicas <= n_ranks):
            raise ValueError(
                f"replicas={replicas} outside [1, n_ranks={n_ranks}]"
            )
        self.n_ranks = n_ranks
        self.slots_per_rank = slots_per_rank
        self.page_elems = page_elems
        self.replicas = replicas
        self._free: List[List[int]] = [
            list(range(slots_per_rank - 1, -1, -1)) for _ in range(n_ranks)
        ]
        self.holdings: Dict[int, Holding] = {}
        self.failed: set = set()
        self._promoted: set = set()  # rids whose primary leg died
        self.host_mem: Optional[np.ndarray] = (
            np.zeros((n_ranks, slots_per_rank, page_elems), np.float32)
            if host_backed
            else None
        )
        self.metrics = registry if registry is not None else Registry()
        self.swapped_out_pages = 0
        self.swapped_in_pages = 0
        self.replica_pages = 0
        self.quorum_restores = 0
        self.degraded_placements = 0

    # ------------------------------------------------------------------ #
    @property
    def n_free(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def live_ranks(self) -> List[int]:
        return [r for r in range(self.n_ranks) if r not in self.failed]

    def free_slots(self, rank: int) -> int:
        return len(self._free[rank])

    def slot_offset(self, rank: int, slot: int) -> int:
        """Flat carrier offset of a tier slot in memory rank ``rank``'s
        segment partition (the tier analogue of ``PoolMap.offset``)."""
        del rank  # each rank's partition is self-addressed
        return int(slot) * self.page_elems

    # ------------------------------------------------------------------ #
    def plan_swap_out(
        self,
        rid: int,
        logical_pages: Sequence[int],
        replicas: Optional[int] = None,
    ) -> Holding:
        """Assign tier slots for one request's materialised pages on up to
        ``replicas`` distinct LIVE memory ranks, most-free first (one
        vectored put per leg carries the whole request out; one vectored
        get from any surviving leg brings it back).  The primary leg must
        fit or :class:`OutOfSlotsError` raises; missing extra legs only
        degrade (counted, not fatal — a tier under slot pressure keeps
        accepting swaps at reduced durability)."""
        if rid in self.holdings:
            raise TierError(f"request {rid} already swapped out")
        logical = tuple(sorted(int(p) for p in logical_pages))
        if not logical:
            raise TierError(f"request {rid} has no materialised pages")
        want = self.replicas if replicas is None else int(replicas)
        want = max(1, min(want, len(self.live_ranks)))
        order = sorted(
            self.live_ranks, key=lambda r: len(self._free[r]), reverse=True
        )
        chosen = [r for r in order if len(self._free[r]) >= len(logical)]
        chosen = chosen[:want]
        if not chosen:
            best = max((len(self._free[r]) for r in order), default=0)
            raise OutOfSlotsError(
                f"swap-out of {len(logical)} pages: best live memory rank "
                f"has {best}/{self.slots_per_rank} slots free"
            )
        if len(chosen) < want:
            self.degraded_placements += 1
        legs = [
            Placement(
                rank=r,
                slots=tuple(self._free[r].pop() for _ in logical),
            )
            for r in chosen
        ]
        h = Holding(
            rank=legs[0].rank,
            logical=logical,
            slots=legs[0].slots,
            replicas=tuple(legs[1:]),
        )
        self.holdings[rid] = h
        self.swapped_out_pages += len(logical)
        self.replica_pages += len(logical) * (len(legs) - 1)
        return h

    def restore_placement(self, rid: int) -> Placement:
        """The placement a swap-in should read: the primary when its rank
        is live, else the first surviving replica (the quorum read —
        also counted when :meth:`mark_failed` already promoted a replica
        into the primary seat).  Raises :class:`TierError` when every
        leg is on a failed rank."""
        h = self.holdings.get(rid)
        if h is None:
            raise TierError(f"request {rid} holds no tier slots")
        for i, pl in enumerate(h.placements):
            if pl.rank not in self.failed:
                if i > 0 or rid in self._promoted:
                    self.quorum_restores += 1
                    self._promoted.discard(rid)
                    tr = obs_trace.active()
                    if tr.enabled:
                        tr.instant(
                            "quorum_restore", cat="ft", rid=rid,
                            leg=i, rank=pl.rank,
                        )
                return pl
        raise TierError(f"request {rid}: no live replica (all legs failed)")

    def release(self, rid: int) -> Holding:
        """Drop one request's tier residency (at swap-in completion, or at
        abort) and return every live leg's slots to its rank's free list
        (a failed rank's slots died with it)."""
        h = self.holdings.pop(rid, None)
        if h is None:
            raise TierError(f"request {rid} holds no tier slots")
        self._promoted.discard(rid)
        for pl in h.placements:
            if pl.rank in self.failed:
                continue
            for s in pl.slots:
                if s in self._free[pl.rank]:
                    raise TierError(
                        f"double free of tier slot {pl.rank}:{s}"
                    )
                self._free[pl.rank].append(s)
        self.swapped_in_pages += len(h.slots)
        return h

    # ---- membership ---------------------------------------------------- #
    def mark_failed(self, rank: int) -> List[int]:
        """A memory rank died: drop it from the allocator, scrub its
        placements, and return the requests whose LAST live placement it
        held — their tier bytes are unrecoverable and the caller must
        fall back to recompute-resume.  Idempotent."""
        if not (0 <= rank < self.n_ranks):
            raise TierError(f"memory rank {rank} outside tier")
        if rank in self.failed:
            return []
        self.failed.add(rank)
        self._free[rank] = []
        lost: List[int] = []
        for rid, h in list(self.holdings.items()):
            legs = [pl for pl in h.placements if pl.rank != rank]
            if len(legs) == len(h.placements):
                continue
            if not legs:
                lost.append(rid)
                del self.holdings[rid]
                self._promoted.discard(rid)
                continue
            if h.rank == rank:
                self._promoted.add(rid)
            self.holdings[rid] = Holding(
                rank=legs[0].rank,
                logical=h.logical,
                slots=legs[0].slots,
                replicas=tuple(legs[1:]),
            )
        return lost

    def admit_rank(self, rank: int) -> None:
        """Re-admit a recovered (or replacement) memory rank with a fresh
        slot map — its previous bytes are gone, so it rejoins empty."""
        if rank not in self.failed:
            raise TierError(f"memory rank {rank} is not failed")
        self.failed.discard(rank)
        self._free[rank] = list(range(self.slots_per_rank - 1, -1, -1))

    # ---- host-backed byte path (colocated server) --------------------- #
    def host_store(self, rid: int, rows: Any) -> Holding:
        """Swap-out without a wire: copy the page rows into the host-side
        tier arrays at EVERY live placement (rows follow
        ``plan_swap_out``'s ascending logical order) — the host analogue
        of the fanned vectored put."""
        if self.host_mem is None:
            raise TierError("tier is not host-backed")
        rows = np.asarray(rows, np.float32)
        h = self.holdings.get(rid)
        if h is None:
            raise TierError(f"plan_swap_out({rid}) first")
        if rows.shape != (len(h.slots), self.page_elems):
            raise TierError(
                f"swap rows {rows.shape} != ({len(h.slots)}, {self.page_elems})"
            )
        for pl in h.placements:
            if pl.rank in self.failed:
                continue
            for row, s in zip(rows, pl.slots):
                self.host_mem[pl.rank, s] = row
        return h

    def host_load(self, rid: int) -> np.ndarray:
        """Swap-in without a wire: the stored rows from the first live
        placement, ascending logical order (the caller releases the
        holding after installing them)."""
        if self.host_mem is None:
            raise TierError("tier is not host-backed")
        pl = self.restore_placement(rid)
        return np.stack([self.host_mem[pl.rank, s] for s in pl.slots])

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, int]:
        # point-in-time values land in the registry as explicit Gauges
        # (they survive reset(); the counters above are what reset clears)
        g = self.metrics.gauge
        g("tier_free_slots").set(self.n_free)
        g("tier_resident_requests").set(len(self.holdings))
        g("tier_failed_ranks").set(len(self.failed))
        return {
            "tier_ranks": self.n_ranks,
            "tier_slots": self.n_ranks * self.slots_per_rank,
            "tier_free_slots": self.n_free,
            "tier_resident_requests": len(self.holdings),
            "tier_swapped_out_pages": self.swapped_out_pages,
            "tier_swapped_in_pages": self.swapped_in_pages,
            "tier_replicas": self.replicas,
            "tier_replica_pages": self.replica_pages,
            "tier_quorum_restores": self.quorum_restores,
            "tier_degraded_placements": self.degraded_placements,
            "tier_failed_ranks": len(self.failed),
        }


def check_tier(tier: MemoryTier, resident_rids: Sequence[int] = ()) -> None:
    """Assert the tier invariant: free lists are duplicate-free, holdings
    (every live placement leg) and free lists partition every LIVE rank's
    slots exactly, no placement references a failed rank, and no request
    is resident in both tiers (``resident_rids`` = requests holding pool
    pages)."""
    used: Dict[int, set] = {r: set() for r in range(tier.n_ranks)}
    for rid, h in tier.holdings.items():
        for pl in h.placements:
            if pl.rank in tier.failed:
                raise AssertionError(
                    f"holding {rid}: placement on failed rank {pl.rank}"
                )
            if len(pl.slots) != len(h.logical):
                raise AssertionError(f"holding {rid}: slots != logical pages")
            for s in pl.slots:
                if s in used[pl.rank]:
                    raise AssertionError(
                        f"tier slot {pl.rank}:{s} held by two placements"
                    )
                used[pl.rank].add(s)
        ranks = [pl.rank for pl in h.placements]
        if len(set(ranks)) != len(ranks):
            raise AssertionError(
                f"holding {rid}: two placements on one rank {ranks}"
            )
    for r in range(tier.n_ranks):
        free = tier._free[r]
        if r in tier.failed:
            if free:
                raise AssertionError(f"failed rank {r} has free slots")
            continue
        if len(set(free)) != len(free):
            raise AssertionError(f"duplicate slots on rank {r} free list")
        if used[r] & set(free):
            raise AssertionError(f"rank {r}: held slot also on free list")
        if len(used[r]) + len(free) != tier.slots_per_rank:
            raise AssertionError(
                f"rank {r}: {len(used[r])} held + {len(free)} free != "
                f"{tier.slots_per_rank}"
            )
    both = set(tier.holdings) & set(int(r) for r in resident_rids)
    if both:
        raise AssertionError(
            f"request(s) {sorted(both)} resident in pool AND tier"
        )


# --------------------------------------------------------------------------- #
# device plane: swap bytes over the GAS layer
# --------------------------------------------------------------------------- #
def _flags(flags: Any, m: int, device) -> torch.Tensor:
    if flags is None:
        return torch.ones((m,), dtype=torch.int32, device=device)
    return torch.as_tensor(flags, device=device).to(torch.int32).reshape(-1)


def swap_out_pages(
    node: Any,
    seg: torch.Tensor,
    src_offsets: Any,
    dst_offsets: Any,
    *,
    to: Any,
    page_elems: int,
    flags: Any = None,
    plan: Optional[sched.CollectivePlan] = None,
    n_batches: Optional[int] = None,
    costs: Optional[Dict[str, sched.EngineCost]] = None,
) -> Tuple[List[Any], sched.CollectivePlan]:
    """Initiate the split-phase swap-out of m pool pages to a memory rank.

    Reads each page at flat offset ``src_offsets[j]`` of the local pool
    shard and lands it at ``dst_offsets[j]`` of node ``pattern(me)``'s
    partition via the vectored put (``node.put_nbv`` — payloads + command
    block per batch, batch count from ``sched.plan_p2p`` on the total
    byte count).  ``flags`` gates per page (a rank swapping fewer than m
    pages this tick clears the tail).  Replication is the caller fanning
    this call once per placement leg — same sources, each leg's offsets
    and permutation.  Returns ``(handles, plan)``; drain with
    ``node.sync`` (or ``node.defer``) per handle.
    """
    dev = node.my_id.device
    src = as_i32(src_offsets, dev).reshape(-1)
    dst = as_i32(dst_offsets, dev).reshape(-1)
    m = int(src.shape[0])
    if int(dst.shape[0]) != m:
        raise ValueError(f"swap_out_pages: {m} sources vs {dst.shape[0]} dests")
    flags = _flags(flags, m, dev)
    local = node.local(seg).reshape(-1)
    pages = [dynamic_slice(local, src[j], page_elems) for j in range(m)]
    if plan is None:
        plan = sched.plan_p2p(
            nbytes=m * page_elems * 4, engine=node.engine, costs=costs
        )
    g = int(plan.n_segments if n_batches is None else n_batches)
    handles = []
    for start, count in segment_bounds(m, g):
        handles.append(
            node.put_nbv(
                seg,
                pages[start : start + count],
                to=to,
                indices=dst[start : start + count],
                pred=flags[start : start + count],
            )
        )
    return handles, plan


def install_pages(
    node: Any,
    seg: torch.Tensor,
    fetched: torch.Tensor,
    dst_offsets: Any,
    flags: Any = None,
) -> torch.Tensor:
    """Land swap-in pages (the ``(m, page_elems)`` stack a vectored get of
    tier slots returned) at ``dst_offsets`` of the local pool shard,
    per-page gated — the receive epilogue of a resume.  Returns the
    updated segment."""
    m, page_elems = int(fetched.shape[0]), int(fetched.shape[1])
    dev = fetched.device
    dst = as_i32(dst_offsets, dev).reshape(-1)
    flags = _flags(flags, m, dev)
    local = node.local(seg)
    flat = local.reshape(-1)
    for j in range(m):
        cur = dynamic_slice(flat, dst[j], page_elems)
        flat = dynamic_update_slice(
            flat, torch.where(flags[j] > 0, fetched[j].to(flat.dtype), cur),
            dst[j],
        )
    return node._restore(seg, flat.reshape(local.shape))
