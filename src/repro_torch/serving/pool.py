"""Paged KV pool of the port: page layout, refcounted allocator, store.

Counterpart of ``repro.serving.pool``:

1. :class:`PagedLayout` — the carrier format: a request cache's token
   axis (``cache_len``) cut into ``n_pages`` pages of ``page_tokens``
   each; every page is one contiguous float32 carrier vector
   (``page_elems``), bit-transparent like
   :class:`~repro_torch.serving.kv.KVLayout` (int leaves bitcast, half
   floats widened exactly).  Leaves are laid out in the reference's
   sorted-key order, so the carrier columns match it offset for offset.
2. The **functional free-list allocator** — :class:`PoolState` is an
   immutable value; :func:`alloc` / :func:`free` / :func:`fork` /
   :func:`writable` return new states.  Pages are refcounted, shared
   pages are copy-on-write.
3. :class:`PagedKVStore` — the pool: the physical page memory (a host
   float32 mirror), the allocator state, per-request page tables and the
   prompt-prefix index.

4. :class:`PoolMap` and :func:`fetch_pages` — global page addressing
   over the ranks' pool segments and the split-phase vectored page fetch
   (``Node.get_nbv``): the swap-in and prefix-migration plane of the
   disaggregated cluster.

Sections 2 and 3 are host bookkeeping identical to the reference's, op
for op.  ``mem`` is a host array for the colocated server and a view of
the rank's device segment in the disaggregated cluster; the store's own
page writes (lazy materialisation, copy-on-write) work on either.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.compat import (
    TensorSpec,
    tree_flatten_with_path,
    tree_leaves,
    tree_unflatten,
)
from repro_torch.core import sched
from repro_torch.core.indexing import as_i32
from repro_torch.serving import kv as kv_lib

__all__ = [
    "PagedLayout",
    "PageLeafSpec",
    "token_axis",
    "PoolState",
    "PoolError",
    "OutOfPagesError",
    "DoubleFreeError",
    "UNMATERIALIZED",
    "make_pool",
    "alloc",
    "free",
    "fork",
    "writable",
    "check_pool",
    "AdmitPlan",
    "PREFIX_CACHE_RID",
    "PIN_RID",
    "PagedKVStore",
    "PoolMap",
    "fetch_pages",
    "sync_fetch",
]

#: Page-table sentinel for a slot whose physical page does not exist yet
#: (lazy allocation) — it materialises when the first position inside it
#: is written.
UNMATERIALIZED = -1

#: Pseudo-table rid owning pages adopted into the prefix index that
#: belong to no request.
PREFIX_CACHE_RID = -1

#: Pseudo-table rid pinning a migration donor's pages while they move.
PIN_RID = -2


# --------------------------------------------------------------------------- #
# 1. Page-granular carrier layout
# --------------------------------------------------------------------------- #
def token_axis(shape: Sequence[int], cache_len: int) -> int:
    """Index of the token (cache) axis in one cache-leaf shape: the unique
    axis of size ``cache_len``."""
    hits = [i for i, d in enumerate(shape) if int(d) == int(cache_len)]
    if len(hits) != 1:
        raise ValueError(
            f"cannot locate the token axis of cache leaf {tuple(shape)}: "
            f"{len(hits)} axes of size {cache_len}"
        )
    return hits[0]


@dataclasses.dataclass(frozen=True)
class PageLeafSpec:
    """One cache leaf's per-page slice of the carrier page."""

    shape: Tuple[int, ...]  # full leaf shape
    dtype: torch.dtype
    axis: int  # token axis
    offset: int  # start column inside the carrier page
    size: int  # carrier elements per page for this leaf
    fill: int = 0  # init value of an unwritten slot (-1 for "pos" leaves)


class PagedLayout:
    """Static page layout of one request's KV cache.

    Built once from a cache-shape tree (``Model.kv_block_struct``);
    :meth:`flatten` / :meth:`unflatten` round-trip any concrete cache of
    that structure through an ``(n_pages, page_elems)`` float32 carrier
    tensor, bit-exactly.  Page ``p`` carries token positions
    ``[p * page_tokens, (p + 1) * page_tokens)`` of every leaf.
    """

    def __init__(
        self,
        treedef: Any,
        leaves: List[PageLeafSpec],
        cache_len: int,
        page_tokens: int,
    ):
        self.treedef = treedef
        self.leaves = leaves
        self.cache_len = int(cache_len)
        self.page_tokens = int(page_tokens)
        self.n_pages = self.cache_len // self.page_tokens
        self.page_elems = sum(leaf.size for leaf in leaves)
        self._empty_row: Optional[np.ndarray] = None

    @classmethod
    def from_struct(
        cls, struct: Any, *, cache_len: int, page_tokens: int
    ) -> "PagedLayout":
        if cache_len % page_tokens:
            raise ValueError(
                f"cache_len={cache_len} not a multiple of "
                f"page_tokens={page_tokens}"
            )
        leaves: List[PageLeafSpec] = []
        offset = 0
        for path, s in tree_flatten_with_path(struct):
            ax = token_axis(s.shape, cache_len)
            size = 1
            for i, d in enumerate(s.shape):
                size *= int(page_tokens) if i == ax else int(d)
            name = path[-1] if path else None
            leaves.append(
                PageLeafSpec(
                    shape=tuple(int(d) for d in s.shape),
                    dtype=s.dtype,
                    axis=ax,
                    offset=offset,
                    size=size,
                    # unwritten cache slots are NOT zeros: position leaves
                    # init to -1 (the empty-slot sentinel attention masks
                    # on); payload leaves init to 0
                    fill=-1 if name == "pos" else 0,
                )
            )
            offset += size
        return cls(struct, leaves, cache_len, page_tokens)

    def pages_for(self, n_tokens: int) -> int:
        """Number of leading pages covering ``n_tokens`` positions."""
        return -(-max(0, int(n_tokens)) // self.page_tokens)

    def _page_shape(self, leaf: PageLeafSpec) -> Tuple[int, ...]:
        return tuple(
            self.page_tokens if i == leaf.axis else d
            for i, d in enumerate(leaf.shape)
        )

    def empty_page_row(self) -> np.ndarray:
        """Carrier row of one ABSENT page: the exact bytes a freshly
        initialised cache holds at unwritten positions (payloads zero,
        ``pos`` = -1, which bitcasts to a NaN in the carrier)."""
        if self._empty_row is None:
            cols = []
            for leaf in self.leaves:
                v = torch.full(self._page_shape(leaf), leaf.fill, dtype=leaf.dtype)
                c = kv_lib.carrier_cast(v).movedim(leaf.axis, 0)
                cols.append(c.reshape(leaf.size))
            self._empty_row = torch.cat(cols).numpy()
        return self._empty_row

    @property
    def page_bytes(self) -> int:
        return self.page_elems * 4  # float32 carrier

    def flatten(self, caches: Any) -> torch.Tensor:
        """Cache tree -> (n_pages, page_elems) float32 carrier pages."""
        vals = tree_leaves(caches)
        if len(vals) != len(self.leaves):
            raise ValueError(
                f"cache has {len(vals)} leaves, layout expects "
                f"{len(self.leaves)}"
            )
        cols = []
        for v, leaf in zip(vals, self.leaves):
            if tuple(v.shape) != leaf.shape:
                raise ValueError(f"cache leaf {tuple(v.shape)} != layout {leaf.shape}")
            c = kv_lib.carrier_cast(v).movedim(leaf.axis, 0)
            cols.append(c.reshape(self.n_pages, leaf.size))
        return torch.cat(cols, dim=1)

    def flatten_page(self, caches: Any, page: int) -> torch.Tensor:
        """One page's carrier row (``(page_elems,)``) without flattening
        the rest of the cache."""
        if not (0 <= page < self.n_pages):
            raise ValueError(f"page {page} outside [0, {self.n_pages})")
        vals = tree_leaves(caches)
        lo = page * self.page_tokens
        cols = []
        for v, leaf in zip(vals, self.leaves):
            if tuple(v.shape) != leaf.shape:
                raise ValueError(f"cache leaf {tuple(v.shape)} != layout {leaf.shape}")
            window = v.narrow(leaf.axis, lo, self.page_tokens)
            c = kv_lib.carrier_cast(window).movedim(leaf.axis, 0)
            cols.append(c.reshape(leaf.size))
        return torch.cat(cols)

    def decode_views(self, mem: torch.Tensor) -> Any:
        """Per-layer page-pool views of a physical pool for the paged
        decode step: each serving-cache leaf ``(L, 1, cache_len, *tail)``
        becomes ``(L, n_phys_pages, page_tokens, *tail)`` — the
        ``k_pages``/``v_pages`` shape the paged-attention kernel reads
        through a page table.  ``mem`` is any ``(P, page_elems)`` carrier
        pool (possibly with extra scratch rows).  Bit-transparent per leaf
        dtype; the results are contiguous, so each layer's pool is one
        dense ``(P, T, *tail)`` block."""
        n_phys = mem.shape[0]
        vals = []
        for leaf in self.leaves:
            if len(leaf.shape) < 3 or leaf.axis != 2 or leaf.shape[1] != 1:
                raise ValueError(
                    f"decode_views needs (L, 1, cache_len, ...) serving "
                    f"leaves, got {leaf.shape} (token axis {leaf.axis})"
                )
            tail = leaf.shape[3:]
            col = mem[:, leaf.offset : leaf.offset + leaf.size]
            x = col.reshape((n_phys, self.page_tokens, leaf.shape[0], 1) + tail)
            x = x.movedim(2, 0)[:, :, :, 0]  # (L, P, T, *tail)
            vals.append(kv_lib.carrier_uncast(x.contiguous(), leaf.dtype))
        return tree_unflatten(self.treedef, vals)

    def views_to_pool(self, views: Any) -> torch.Tensor:
        """Inverse of :meth:`decode_views`: per-layer page pools back into
        the ``(P, page_elems)`` carrier array (bit-exact round trip)."""
        vals = tree_leaves(views)
        if len(vals) != len(self.leaves):
            raise ValueError(
                f"views have {len(vals)} leaves, layout expects "
                f"{len(self.leaves)}"
            )
        cols = []
        for v, leaf in zip(vals, self.leaves):
            x = kv_lib.carrier_cast(v)  # (L, P, T, *tail)
            x = x[:, :, :, None].movedim(0, 2)  # (P, T, L, 1, *tail)
            cols.append(x.reshape(x.shape[0], leaf.size))
        return torch.cat(cols, dim=1)

    def shard_heads(
        self, tp: int, n_kv_heads: int
    ) -> Tuple["PagedLayout", np.ndarray]:
        """Head-shard axis for tensor-parallel decode groups.

        Returns ``(shard_layout, cols)``: the :class:`PagedLayout` of ONE
        rank's pool shard (``k``/``v`` leaves keep only ``KH/tp`` heads;
        ``pos`` and other head-free leaves replicated) plus an
        ``(tp, shard_page_elems)`` int array of full-page carrier columns
        such that shard ``s`` of a page row is ``row[cols[s]]`` — and the
        full row is rebuilt by scattering every shard back through its
        columns (``k``/``v`` columns partition; replicated columns agree
        bit-for-bit on every shard, so reassembly order is immaterial).

        Page ids, page tables, the allocator and the prefix index are all
        shard-invariant: every rank of a group holds the same table and
        the same page count, just ``1/tp``-th of each page's bytes.
        """
        if tp <= 1:
            return self, np.arange(self.page_elems)[None]
        if n_kv_heads % tp:
            raise ValueError(
                f"tp={tp} must divide n_kv_heads={n_kv_heads}"
            )
        kh_l = n_kv_heads // tp
        cols: List[List[np.ndarray]] = [[] for _ in range(tp)]
        shard_vals = []
        for (path, _), leaf in zip(tree_flatten_with_path(self.treedef),
                                   self.leaves):
            name = path[-1] if path else None
            inner = (
                (self.page_tokens,)
                + leaf.shape[: leaf.axis]
                + leaf.shape[leaf.axis + 1 :]
            )
            idx = np.arange(leaf.size).reshape(inner) + leaf.offset
            if name in ("k", "v"):
                if (
                    len(leaf.shape) < 4
                    or leaf.axis != 2
                    or leaf.shape[3] != n_kv_heads
                ):
                    raise ValueError(
                        f"cannot head-shard {name!r} leaf {leaf.shape}: "
                        f"expected (L, 1, cache_len, {n_kv_heads}, ...)"
                    )
                # inner layout is (T, L, 1, KH, *rest): head axis 3
                for s in range(tp):
                    sel = idx[:, :, :, s * kh_l : (s + 1) * kh_l]
                    cols[s].append(sel.reshape(-1))
                shape = leaf.shape[:3] + (kh_l,) + leaf.shape[4:]
            else:
                for s in range(tp):
                    cols[s].append(idx.reshape(-1))
                shape = leaf.shape
            shard_vals.append(TensorSpec(shape, leaf.dtype))
        shard_struct = tree_unflatten(self.treedef, shard_vals)
        shard_layout = PagedLayout.from_struct(
            shard_struct, cache_len=self.cache_len,
            page_tokens=self.page_tokens,
        )
        return shard_layout, np.stack([np.concatenate(c) for c in cols])

    def unflatten(self, pages: Any) -> Any:
        """(n_pages, page_elems) carrier pages -> cache tree."""
        pages = torch.as_tensor(pages)
        if tuple(pages.shape) != (self.n_pages, self.page_elems):
            raise ValueError(
                f"pages {tuple(pages.shape)} != layout "
                f"({self.n_pages}, {self.page_elems})"
            )
        vals = []
        for leaf in self.leaves:
            col = pages[:, leaf.offset : leaf.offset + leaf.size]
            moved = (
                (self.cache_len,)
                + leaf.shape[: leaf.axis]
                + leaf.shape[leaf.axis + 1 :]
            )
            x = col.reshape(moved).movedim(0, leaf.axis)
            vals.append(kv_lib.carrier_uncast(x.contiguous(), leaf.dtype))
        return tree_unflatten(self.treedef, vals)


# --------------------------------------------------------------------------- #
# 2. Functional page allocator (refcounted free list)
# --------------------------------------------------------------------------- #
class PoolError(RuntimeError):
    """Base allocator error."""


class OutOfPagesError(PoolError):
    """The free list is empty (pool oversubscribed)."""


class DoubleFreeError(PoolError):
    """A page with no live references was freed again."""


@dataclasses.dataclass(frozen=True)
class PoolState:
    """Immutable allocator state: LIFO free list + per-page refcounts.

    A page is either *free* (refcount 0, on the free list exactly once)
    or *live* (refcount >= 1, not on the free list) — the invariant
    :func:`check_pool` asserts and the hypothesis suite hammers.
    """

    free: Tuple[int, ...]
    refcnt: Tuple[int, ...]

    @property
    def n_pages(self) -> int:
        return len(self.refcnt)

    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_live(self) -> int:
        return self.n_pages - self.n_free


def make_pool(n_pages: int) -> PoolState:
    if n_pages < 1:
        raise ValueError(f"need at least one page, got {n_pages}")
    return PoolState(free=tuple(range(n_pages - 1, -1, -1)), refcnt=(0,) * n_pages)


def alloc(state: PoolState, n: int = 1) -> Tuple[PoolState, Tuple[int, ...]]:
    """Pop ``n`` pages off the free list (refcount 1 each)."""
    if n > state.n_free:
        raise OutOfPagesError(
            f"alloc({n}) with {state.n_free}/{state.n_pages} pages free"
        )
    pages = state.free[-n:][::-1] if n else ()
    refcnt = list(state.refcnt)
    for p in pages:
        refcnt[p] = 1
    return PoolState(state.free[: len(state.free) - n], tuple(refcnt)), pages


def fork(state: PoolState, pages: Sequence[int]) -> PoolState:
    """Add one reference to every page in ``pages`` (prefix sharing: a new
    request maps the same physical pages)."""
    refcnt = list(state.refcnt)
    for p in pages:
        if refcnt[p] < 1:
            raise PoolError(f"fork of free page {p}")
        refcnt[p] += 1
    return PoolState(state.free, tuple(refcnt))


def free(state: PoolState, pages: Sequence[int]) -> PoolState:
    """Drop one reference per page; pages reaching refcount 0 return to
    the free list.  Freeing an already-free page raises
    :class:`DoubleFreeError` (never silently corrupts the list)."""
    refcnt = list(state.refcnt)
    free_list = list(state.free)
    for p in pages:
        if not (0 <= p < len(refcnt)):
            raise PoolError(f"free of page {p} outside pool")
        if refcnt[p] < 1:
            raise DoubleFreeError(f"double free of page {p}")
        refcnt[p] -= 1
        if refcnt[p] == 0:
            free_list.append(p)
    return PoolState(tuple(free_list), tuple(refcnt))


def writable(state: PoolState, page: int) -> Tuple[PoolState, int, bool]:
    """Copy-on-write resolve: return ``(state, page', copied)`` where
    ``page'`` is safe to mutate for one owner.  A privately held page
    (refcount 1) is returned as-is; a shared page allocates a fresh page
    and drops one reference on the original — the caller copies the
    payload ``mem[page] -> mem[page']``."""
    if state.refcnt[page] < 1:
        raise PoolError(f"writable() on free page {page}")
    if state.refcnt[page] == 1:
        return state, page, False
    state, (fresh,) = alloc(state, 1)
    state = free(state, (page,))
    return state, fresh, True


def check_pool(
    state: PoolState,
    tables: Optional[Sequence[Sequence[int]]] = None,
    evicted: Optional[Sequence[Sequence[int]]] = None,
) -> None:
    """Assert the allocator invariant (used by the property tests).

    With ``tables`` (the resident page tables, possibly holding
    :data:`UNMATERIALIZED` slots) the check extends to the
    oversubscription seam: every materialised entry must be live and
    every reference must be table-borne — ``refcnt[p]`` equals the
    entry's multiplicity across tables, so unmaterialised slots carry no
    refcount and no page is referenced off the books.  With ``evicted``
    (the page tables of swapped-out requests, as snapshotted at
    preemption) the check asserts those requests hold NO pool reference:
    an evicted-but-referenced page lives in the memory tier, and its old
    physical page is either recycled or owned by surviving sharers —
    never still pinned by the preempted request."""
    if len(set(state.free)) != len(state.free):
        raise AssertionError(f"duplicate pages on free list: {state.free}")
    for p in state.free:
        if state.refcnt[p] != 0:
            raise AssertionError(f"page {p} free with refcount {state.refcnt[p]}")
    live = sum(1 for c in state.refcnt if c > 0)
    if live + state.n_free != state.n_pages:
        raise AssertionError(
            f"{live} live + {state.n_free} free != {state.n_pages} pages"
        )
    if tables is not None:
        counts = [0] * state.n_pages
        for t in tables:
            for p in t:
                if p == UNMATERIALIZED:
                    continue
                if not (0 <= p < state.n_pages):
                    raise AssertionError(f"table entry {p} outside pool")
                counts[p] += 1
        for p, (want, got) in enumerate(zip(counts, state.refcnt)):
            if want != got:
                raise AssertionError(
                    f"page {p}: {want} table reference(s) vs refcount {got}"
                )
    if evicted is not None:
        resident = (
            {p for t in tables for p in t if p != UNMATERIALIZED}
            if tables is not None
            else None
        )
        for t in evicted:
            for p in t:
                if p == UNMATERIALIZED:
                    continue
                if resident is not None and p in resident:
                    continue  # recycled to (or shared with) a live request
                if 0 <= p < state.n_pages and state.refcnt[p] != 0:
                    raise AssertionError(
                        f"evicted page {p} still holds refcount "
                        f"{state.refcnt[p]} with no table referencing it"
                    )


# --------------------------------------------------------------------------- #
# 3. One rank's pool shard: memory + tables + prefix index
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AdmitPlan:
    """Placement decision for one request: its page table, which pages are
    fresh (must be written/transferred) vs prefix-shared (already
    resident — the transfer ships them ``pred=False``).  Lazy admissions
    leave the tail :data:`UNMATERIALIZED` (no physical page yet): those
    slots are neither fresh nor shared."""

    table: Tuple[int, ...]
    fresh: Tuple[bool, ...]

    @property
    def shared(self) -> Tuple[int, ...]:
        return tuple(
            p for p, f in zip(self.table, self.fresh)
            if not f and p != UNMATERIALIZED
        )

    @property
    def n_materialized(self) -> int:
        return sum(1 for p in self.table if p != UNMATERIALIZED)


class PagedKVStore:
    """One decode rank's shard of the global KV pool.

    ``mem`` is the rank's physical page array ``(n_pages, page_elems)``
    float32 — the host mirror of the rank's GASNet segment (the
    disaggregated cluster transfers pages into the segment one-sided and
    refreshes ``mem`` from it each tick; the colocated server writes it
    directly).  All bookkeeping (allocator state, page tables, prefix
    index) is host-side and functional at the allocator layer.

    Prefix sharing: a *full* prompt page (every one of its
    ``page_tokens`` positions covered by the prompt) is keyed by the
    token chain from position 0 through its last token.  ``admit`` of a
    prompt whose leading chain matches resident keys maps those physical
    pages into the new request's table (``fork``) instead of allocating;
    only the tail is fresh.  Decode never mutates a shared page — the
    first write past the prompt lands in the request's own tail page, and
    :func:`writable` copy-on-write protects the boundary page when the
    prompt length is not page-aligned.
    """

    def __init__(self, layout: PagedLayout, n_pages: int, mem: Any = None):
        self.layout = layout
        self.state = make_pool(n_pages)
        self.mem = (np.zeros((n_pages, layout.page_elems), np.float32)
                    if mem is None else mem)
        self._empty_dev: Optional[torch.Tensor] = None
        self.tables: Dict[int, Tuple[int, ...]] = {}
        # full-page token chain -> resident physical page
        self._prefix: Dict[Tuple[int, ...], int] = {}
        self._page_key: Dict[int, Tuple[int, ...]] = {}
        self.prefix_hits = 0
        self.prefix_misses = 0
        # replica-aware swap bookkeeping (fault tolerance): how many pages
        # left this shard under each durability level, and which evicted
        # requests still have replicated tier copies
        self.swap_out_replica_pages = 0
        self.swapped_replicated: Dict[int, int] = {}

    def _empty_row(self) -> Any:
        """The absent page's carrier row in ``mem``'s own kind: a host
        array, or a tensor on ``mem``'s device (built once)."""
        row = self.layout.empty_page_row()
        if not isinstance(self.mem, torch.Tensor):
            return row
        if self._empty_dev is None or self._empty_dev.device != self.mem.device:
            self._empty_dev = torch.from_numpy(row).to(self.mem.device)
        return self._empty_dev

    # ------------------------------------------------------------------ #
    def plan_admit(self, prompt: Sequence[int], lazy: bool = False) -> AdmitPlan:
        """Allocate a page table for one request, prefix-sharing resident
        full prompt pages.  Pure allocator mutation; the payload write (or
        one-sided transfer) of the fresh pages happens separately.

        ``lazy=True`` materialises only the pages the prompt covers; the
        generation tail stays :data:`UNMATERIALIZED` and pages appear as
        positions are written (:meth:`prepare_write`) — so the pool can
        admit an aggregate logical demand larger than its physical
        capacity (oversubscription)."""
        pt = self.layout.page_tokens
        n_shareable = len(prompt) // pt  # only fully-covered prompt pages
        n_backed = (
            self.layout.pages_for(len(prompt)) if lazy else self.layout.n_pages
        )
        table: List[int] = []
        fresh: List[bool] = []
        prompt = tuple(int(t) for t in prompt)
        chain_live = True
        for p in range(self.layout.n_pages):
            if p >= n_backed:
                table.append(UNMATERIALIZED)
                fresh.append(False)
                continue
            page_id = None
            if chain_live and p < n_shareable:
                page_id = self._prefix.get(prompt[: (p + 1) * pt])
            if page_id is not None:
                self.state = fork(self.state, (page_id,))
                table.append(page_id)
                fresh.append(False)
                self.prefix_hits += 1
            else:
                chain_live = False  # sharing must be a leading run
                self.state, (new_page,) = alloc(self.state, 1)
                table.append(new_page)
                fresh.append(True)
                if p < n_shareable:
                    key = prompt[: (p + 1) * pt]
                    self._prefix[key] = new_page
                    self._page_key[new_page] = key
                    self.prefix_misses += 1
        return AdmitPlan(table=tuple(table), fresh=tuple(fresh))

    def commit(self, rid: int, plan: AdmitPlan) -> None:
        self.tables[rid] = plan.table

    def write_pages(self, plan: AdmitPlan, pages: Any) -> None:
        """Host write of the fresh pages (the colocated path; the
        disaggregated path lands them one-sided into the segment)."""
        pages = np.asarray(pages, np.float32)
        for p, (page_id, is_fresh) in enumerate(zip(plan.table, plan.fresh)):
            if is_fresh:
                self.mem[page_id] = pages[p]

    def admit(self, rid: int, prompt: Sequence[int], pages: Any) -> AdmitPlan:
        """plan + write + commit in one call (colocated server path)."""
        plan = self.plan_admit(prompt)
        self.write_pages(plan, pages)
        self.commit(rid, plan)
        return plan

    def prefix_match(self, prompt: Sequence[int]) -> int:
        """Number of leading full prompt pages already resident (the
        prefix-affinity routing signal: admit where the match is longest
        and those pages ship nothing)."""
        pt = self.layout.page_tokens
        prompt = tuple(int(t) for t in prompt)
        n = 0
        for p in range(len(prompt) // pt):
            if self._prefix.get(prompt[: (p + 1) * pt]) is None:
                break
            n += 1
        return n

    # ------------------------------------------------------------------ #
    def gather(self, rid: int) -> Any:
        """Read one request's cache back through its page table.
        Unmaterialised slots synthesise the absent page
        (:meth:`PagedLayout.empty_page_row`): a recycled physical page's
        stale bytes can never reach attention through a lazy table."""
        table = self.tables[rid]
        if all(p != UNMATERIALIZED for p in table):
            return self.layout.unflatten(self.mem[list(table)])
        empty = self.layout.empty_page_row()
        rows = np.stack(
            [self.mem[p] if p != UNMATERIALIZED else empty for p in table]
        )
        return self.layout.unflatten(rows)

    def page_table(self, rid: int) -> Tuple[int, ...]:
        return self.tables[rid]

    def freeable(self, rid: int) -> int:
        """Pages that would return to the free list if ``rid`` were
        evicted — refcount-aware: prefix-shared physical pages stay with
        their sharers, unmaterialised slots hold nothing.  The victim
        *value* signal the preemption scheduler sums."""
        table = self.tables.get(rid, ())
        return sum(
            1 for p in table
            if p != UNMATERIALIZED and self.state.refcnt[p] == 1
        )

    def device_table(self, rid: int, absent: int) -> Tuple[int, ...]:
        """The table with unmaterialised slots replaced by ``absent`` (a
        scratch physical page) — the form the paged-attention kernel
        consumes: every entry must be a valid physical id, and absent
        slots are masked by ``lengths`` anyway."""
        return tuple(
            absent if p == UNMATERIALIZED else p for p in self.tables[rid]
        )

    def prepare_write(self, rid: int, position: int) -> int:
        """Make the page holding ``position`` writable for ``rid`` and
        return its physical id: a lazy slot materialises (alloc), a
        shared page copy-on-write splits, and the written page leaves the
        prefix index (its chain no longer matches).  This is the
        bookkeeping half of a decode-step write; the payload lands either
        host-side (:meth:`write_token_page`) or on-device (the paged
        decode step scattering straight into the pool)."""
        table = list(self.tables[rid])
        p = position // self.layout.page_tokens
        page_id = table[p]
        if page_id == UNMATERIALIZED:
            self.state, (dst,) = alloc(self.state, 1)
            table[p] = dst
            self.tables[rid] = tuple(table)
            # a materialising page starts absent: synthesise its init row
            # so the bytes of whoever held it before never resurface
            self.mem[dst] = self._empty_row()
        else:
            self.state, dst, copied = writable(self.state, page_id)
            if copied:
                table[p] = dst
                self.tables[rid] = tuple(table)
                # COW payload copy: the fresh page starts as a bit-exact
                # copy of the shared original
                self.mem[dst] = self.mem[page_id]
        # a mutated page no longer matches its prompt chain: drop the key
        key = self._page_key.pop(dst, None)
        if key is not None and self._prefix.get(key) == dst:
            del self._prefix[key]
        return dst

    def write_token_page(self, rid: int, position: int, page_row: Any) -> int:
        """Install the page holding ``position`` after a decode step wrote
        that token.  ``page_row`` must be the page's FULL carrier row
        (``PagedLayout.flatten_page``).  Copy-on-write and lazy
        materialisation via :meth:`prepare_write`.  Returns the physical
        page written."""
        dst = self.prepare_write(rid, position)
        self.mem[dst] = np.asarray(page_row, np.float32)
        return dst

    def materialize_through(self, rid: int, n_pages: int) -> Tuple[int, ...]:
        """Allocate physical pages for every unmaterialised slot among the
        first ``n_pages`` logical pages (the pre-swap staging step: a
        victim's decode-written positions must have pool pages to ship
        from).  Returns the freshly allocated physical ids; the caller
        stages their payloads."""
        table = list(self.tables[rid])
        fresh: List[int] = []
        try:
            for p in range(min(int(n_pages), len(table))):
                if table[p] == UNMATERIALIZED:
                    self.state, (pp,) = alloc(self.state, 1)
                    table[p] = pp
                    fresh.append(pp)
        except OutOfPagesError:
            # transactional: a partial materialisation must not leak the
            # pages it already took (the caller falls back to recompute)
            if fresh:
                self.state = free(self.state, fresh)
            raise
        self.tables[rid] = tuple(table)
        return tuple(fresh)

    def _drop_refs(self, table: Sequence[int]) -> None:
        live = [p for p in table if p != UNMATERIALIZED]
        self.state = free(self.state, live)
        for page_id in live:
            if self.state.refcnt[page_id] == 0:
                key = self._page_key.pop(page_id, None)
                if key is not None and self._prefix.get(key) == page_id:
                    del self._prefix[key]

    def release(self, rid: int) -> None:
        """Drop one request's references; pages whose last reference drops
        leave the prefix index with them.  Unmaterialised slots hold no
        reference."""
        self._drop_refs(self.tables.pop(rid))

    def evict_request(self, rid: int) -> Tuple[Tuple[int, int], ...]:
        """Preempt ``rid``: return its materialised ``(logical, physical)``
        page pairs, then drop every reference exactly like
        :meth:`release`.  Refcount-aware by construction: a physical page
        still referenced by a running request (prefix-shared) merely loses
        this request's reference — its bytes stay resident for the
        sharers and are never invalidated.  The caller must have captured
        (or swapped out) the payloads *before* evicting, since a fully
        dropped page may be recycled immediately."""
        table = self.tables[rid]
        pairs = tuple(
            (lp, pp) for lp, pp in enumerate(table) if pp != UNMATERIALIZED
        )
        self._drop_refs(self.tables.pop(rid))
        return pairs

    def admit_resume(self, rid: int, logical_pages: Sequence[int]) -> Tuple[int, ...]:
        """Re-admit a preempted request: allocate fresh physical pages for
        its previously materialised logical pages (the swap-in
        destination); the rest of the table stays unmaterialised.
        Resumed tables do not re-enter the prefix index — their chains
        may have diverged from the resident prompts."""
        logical = sorted(int(p) for p in logical_pages)
        self.state, phys = alloc(self.state, len(logical))
        table = [UNMATERIALIZED] * self.layout.n_pages
        for lp, pp in zip(logical, phys):
            table[lp] = pp
        self.tables[rid] = tuple(table)
        return phys

    # ---- replica-aware swap bookkeeping (fault tolerance) ------------- #
    def shared_page_count(self, rid: int) -> int:
        """Materialised pages of ``rid`` referenced by MORE than one table
        — the hot/prefix-shared pages whose tier swap-outs are worth
        replicating (losing them loses every sharer's prefix)."""
        table = self.tables.get(rid, ())
        return sum(
            1
            for p in table
            if p != UNMATERIALIZED and self.state.refcnt[p] > 1
        )

    def note_swap_out(self, rid: int, n_pages: int, replicas: int = 0) -> None:
        """Record that ``rid``'s swap-out left this shard with
        ``replicas`` EXTRA tier copies (0 = unreplicated).  Purely
        bookkeeping — the tier owns the placements; the pool remembers
        the durability so recovery can tell swap-resume from recompute."""
        if replicas > 0:
            self.swap_out_replica_pages += int(n_pages) * int(replicas)
            self.swapped_replicated[rid] = int(replicas)

    def note_swap_in(self, rid: int) -> None:
        """Forget a swapped request's replica record (resume or abort)."""
        self.swapped_replicated.pop(rid, None)

    # ---- prefix-index migration (elastic scale-out) ------------------- #
    def prefix_entries(self) -> List[Tuple[Tuple[int, ...], int]]:
        """The resident prefix index as ``(chain_key, physical_page)``
        rows, shortest chains first — adoption order must follow chain
        order so a capped migration still transfers usable leading runs
        (``prefix_match`` walks keys from the front)."""
        return sorted(self._prefix.items(), key=lambda kv: len(kv[0]))

    def adopt_prefix(
        self, entries: Sequence[Tuple[Tuple[int, ...], int]]
    ) -> List[Tuple[int, int]]:
        """Adopt a donor's prefix index: allocate one local physical page
        per new chain key and index it, owned by the
        :data:`PREFIX_CACHE_RID` pseudo-table (live, shareable, owned by
        no request).  Returns ``(donor_physical, local_physical)`` pairs —
        the vectored-RMA transfer list; the PAYLOAD bytes must land at
        the local pages (over the wire) before any sharer decodes.
        Already-present keys are skipped; stops early when the pool
        cannot fit another page."""
        adopted: List[Tuple[int, int]] = []
        cache = list(self.tables.get(PREFIX_CACHE_RID, ()))
        for key, donor_pp in entries:
            key = tuple(int(t) for t in key)
            if key in self._prefix:
                continue
            try:
                self.state, (pp,) = alloc(self.state, 1)
            except OutOfPagesError:
                break
            self._prefix[key] = pp
            self._page_key[pp] = key
            cache.append(pp)
            adopted.append((int(donor_pp), pp))
        if cache:
            self.tables[PREFIX_CACHE_RID] = tuple(cache)
        return adopted

    def release_prefix_cache(self) -> int:
        """Drop every adopted-but-unowned prefix page (pressure relief or
        shutdown); pages shared with live requests stay with them."""
        table = self.tables.pop(PREFIX_CACHE_RID, ())
        self._drop_refs(table)
        return len(table)

    def pin_pages(self, pages: Sequence[int]) -> None:
        """Hold an extra reference on ``pages`` (a migration donor's
        transfer set) under the :data:`PIN_RID` pseudo-table so retiring
        owners cannot recycle them while the bytes are on the wire."""
        pages = tuple(int(p) for p in pages)
        self.state = fork(self.state, pages)
        self.tables[PIN_RID] = self.tables.get(PIN_RID, ()) + pages

    def unpin_pages(self) -> None:
        """Drop every migration pin (the transfer landed or aborted)."""
        self._drop_refs(self.tables.pop(PIN_RID, ()))

    # ------------------------------------------------------------------ #
    @property
    def n_free(self) -> int:
        return self.state.n_free

    def stats(self) -> Dict[str, int]:
        return {
            "n_pages": self.state.n_pages,
            "n_free": self.state.n_free,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "swap_out_replica_pages": self.swap_out_replica_pages,
            "prefix_cache_pages": len(self.tables.get(PREFIX_CACHE_RID, ())),
        }


# --------------------------------------------------------------------------- #
# 4. The global address space + split-phase vectored page fetch
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PoolMap:
    """Global page addressing over the sharded pool segment: decode rank
    ``r`` owns local pages ``[0, pages_per_rank)``; global page ``g``
    lives at flat carrier offset ``local(g) * page_elems`` of rank
    ``owner(g)``'s partition — a (node, index) global address exactly as
    in ``core.addrspace``."""

    n_ranks: int
    pages_per_rank: int
    page_elems: int

    @property
    def n_pages(self) -> int:
        return self.n_ranks * self.pages_per_rank

    def owner(self, g: int) -> int:
        return int(g) // self.pages_per_rank

    def local(self, g: int) -> int:
        return int(g) % self.pages_per_rank

    def global_id(self, rank: int, local: int) -> int:
        return int(rank) * self.pages_per_rank + int(local)

    def offset(self, g: Any, device: Any = None) -> torch.Tensor:
        """Flat carrier offset of a (possibly batched) global page id in
        its owner's partition."""
        return (as_i32(g, device) % self.pages_per_rank) * self.page_elems


def fetch_pages(
    node: Any,
    seg: torch.Tensor,
    page_offsets: Any,
    *,
    frm: Any,
    page_elems: int,
    plan: Optional[sched.CollectivePlan] = None,
    n_batches: Optional[int] = None,
    costs: Optional[Dict[str, sched.EngineCost]] = None,
    pred: Any = None,
) -> Tuple[List[Any], sched.CollectivePlan]:
    """Initiate the split-phase prefetch of remote KV pages.

    ``page_offsets`` are flat carrier offsets in the source partition
    (``PoolMap.offset`` of each global page id).  The fetch is issued as
    vectored gets (``node.get_nbv`` — m offsets per request/reply pair);
    ``sched.plan_p2p`` on the total byte count picks how many batches to
    keep in flight.

    Returns ``(handles, plan)``.
    """
    offs = as_i32(page_offsets, node.my_id.device).reshape(-1)
    m = int(offs.shape[0])
    if plan is None:
        plan = sched.plan_p2p(
            nbytes=m * page_elems * 4, engine=node.engine, costs=costs
        )
    g = int(plan.n_segments if n_batches is None else n_batches)
    handles = []
    for start, count in kv_lib.segment_bounds(m, g):
        handles.append(
            node.get_nbv(
                seg,
                frm=frm,
                indices=offs[start : start + count],
                size=page_elems,
                pred=pred,
            )
        )
    return handles, plan


def sync_fetch(node: Any, handles: Sequence[Any]) -> torch.Tensor:
    """Drain one prefetch's handles in issue order; returns the
    ``(n_pages, page_elems)`` carrier stack."""
    return torch.cat([node.sync(h) for h in handles], dim=0)
