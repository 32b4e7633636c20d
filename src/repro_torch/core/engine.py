"""Communication engines: the "software GASNet node" vs the "GAScore".

The paper's central demonstration is that software nodes (x86/ARM GASNet)
and hardware nodes (the GAScore remote-DMA engine) interoperate through one
API.  The port reproduces the reference's split (``repro.core.engine``):

- :class:`XlaEngine`     — the *software node*: the transport is PyTorch
  indexing on the rank-stacked tensor (the counterpart of ``lax.ppermute``
  and XLA's collectives).
- :class:`GascoreEngine` — the *hardware node*: the same primitives are the
  hand-written CUDA kernels of ``repro_torch.kernels.gascore``.

Both expose the identical :class:`CommEngine` interface, so any code built
on top (the ring collectives, the AM router, user programs) migrates from
software to hardware by swapping the engine.

All transport methods must be called inside ``Context.spmd``, where the
engine holds the batched rank ids (``my_id``); each transfer is one
transport op (``repro_torch.core.transport``) for all ranks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import transport

__all__ = [
    "CommEngine",
    "Pending",
    "AlreadyWaitedError",
    "wait_all",
    "XlaEngine",
    "GascoreEngine",
    "EngineMap",
    "make_engine",
    "parse_backend_spec",
]


class AlreadyWaitedError(RuntimeError):
    """A split-phase handle was synced twice.

    A transfer completes exactly once (``gasnet_wait_syncnb`` semantics);
    the message always names the offending op so batch waits
    (:func:`wait_all`, ``node.sync_all``) are debuggable.
    """


class Pending:
    """An in-flight transport operation (the engine half of split-phase).

    ``shift_nb``/``permute_nb`` return a ``Pending`` at *initiation*;
    ``wait()`` is the *sync point* that yields the delivered value.  In the
    port the transfer is enqueued on the current CUDA stream at initiation,
    and compute issued before ``wait()`` is queued behind it on the same
    stream (no overlap yet: a side stream plus an event is later work).

    ``op`` labels the operation for error messages (``shift(k=1)``,
    ``permute``, ...), so a double-wait names the op.
    """

    __slots__ = ("_value", "_waited", "op")

    def __init__(self, value: torch.Tensor, op: str = "transfer"):
        self._value = value
        self._waited = False
        self.op = op

    @property
    def waited(self) -> bool:
        return self._waited

    def wait(self) -> torch.Tensor:
        """Complete the transfer and return the delivered value (a
        transfer completes exactly once, like ``gasnet_wait_syncnb``)."""
        if self._waited:
            raise AlreadyWaitedError(
                f"Pending {self.op} transfer already waited on"
            )
        self._waited = True
        return self._value

    def ready(self) -> bool:
        """Poll (``gasnet_try_syncnb``).  The static SPMD schedule
        guarantees delivery of every initiated transfer, so this is
        constant-``True`` — kept for API fidelity."""
        return True


def wait_all(pendings: Sequence["Pending"]) -> List[torch.Tensor]:
    """Complete a batch of pendings in issue order (``gasnet_wait_syncnb_all``).

    Idempotence is checked up front: if any entry was already waited on,
    raise one clear error naming the op and its position *before* consuming
    any of the others, so the batch is not left half-drained.
    """
    stale = [(i, p.op) for i, p in enumerate(pendings) if p.waited]
    if stale:
        desc = ", ".join(f"#{i} ({op})" for i, op in stale)
        raise AlreadyWaitedError(
            f"wait_all: pending transfer(s) already waited on: {desc}"
        )
    return [p.wait() for p in pendings]


class CommEngine:
    """Transport primitives of one GASNet node.

    ``axis`` names the rank axis; ``n_nodes`` its size; ``ids`` the batched
    rank ids inside ``Context.spmd`` (None for an engine built only to
    plan, as the scheduler's tests do).

    ``can_permute_partial`` advertises whether :meth:`permute` accepts
    ``None`` destinations (nodes that send nowhere).  The software
    transport can; the GAScore transport cannot — only bijections are
    legal.  The scheduler consults this flag.
    """

    name = "abstract"
    can_permute_partial = False

    def __init__(self, axis: str, n_nodes: int,
                 ids: Optional[torch.Tensor] = None):
        self.axis = axis
        self.n_nodes = n_nodes
        self.ids = ids

    def backend_of(self, rank: int) -> str:
        """Backend name serving ``rank`` (uniform for homogeneous engines;
        :class:`EngineMap` overrides per rank)."""
        return self.name

    # -- point-to-point (one-sided put transport) ----------------------- #
    def shift(self, x: torch.Tensor, k: int = 1) -> torch.Tensor:
        """Every node's ``x`` lands on node ``(me + k) % n``."""
        raise NotImplementedError

    def permute(self, x: torch.Tensor, dst: Sequence[int]) -> torch.Tensor:
        """Static permutation: node i's ``x`` lands on node ``dst[i]``.
        Non-destinations receive zeros."""
        raise NotImplementedError

    # -- split-phase point-to-point (Extended API transport) ------------- #
    def shift_nb(self, x: torch.Tensor, k: int = 1) -> Pending:
        """Non-blocking :meth:`shift`: initiate the transfer of ``x`` to
        node ``(me + k) % n`` and return a :class:`Pending` whose
        ``wait()`` is the sync point."""
        return Pending(self.shift(x, k), op=f"shift(k={k})")

    def permute_nb(self, x: torch.Tensor, dst: Sequence[int]) -> Pending:
        """Non-blocking :meth:`permute` (split-phase, see :meth:`shift_nb`)."""
        return Pending(self.permute(x, dst), op="permute")

    # -- vectored split-phase transport (engine-level multi-get/multi-put) #
    def _pack_nbv(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        flats = [x.reshape(-1) for x in xs]
        dtypes = {f.dtype for f in flats}
        if len(dtypes) > 1:
            raise TypeError(
                f"vectored transfer payloads must share one dtype, got "
                f"{sorted(str(d) for d in dtypes)}"
            )
        return flats[0] if len(flats) == 1 else torch.cat(flats)

    def _unpack_nbv(
        self, moved: torch.Tensor, xs: Sequence[torch.Tensor], op: str
    ) -> List[Pending]:
        out: List[Pending] = []
        offset = 0
        for x in xs:
            piece = moved[offset : offset + x.numel()].reshape(x.shape)
            out.append(Pending(piece, op=op))
            offset += x.numel()
        return out

    def shift_nbv(self, xs: Sequence[torch.Tensor], k: int = 1) -> List[Pending]:
        """Vectored non-blocking shift: ONE transport initiation carries
        every payload in ``xs`` to node ``(me + k) % n``; returns one
        :class:`Pending` per payload.  Payloads must share a dtype (the
        carrier); sizes are static so the receive split is free."""
        xs = list(xs)
        if not xs:
            return []
        moved = self.shift(self._pack_nbv(xs), k)
        return self._unpack_nbv(moved, xs, op=f"shiftv(k={k})")

    def permute_nbv(
        self, xs: Sequence[torch.Tensor], dst: Sequence[int]
    ) -> List[Pending]:
        """Vectored non-blocking :meth:`permute` (see :meth:`shift_nbv`)."""
        xs = list(xs)
        if not xs:
            return []
        moved = self.permute(self._pack_nbv(xs), dst)
        return self._unpack_nbv(moved, xs, op="permutev")

    # -- vectored put transport (payloads + command block in one message) - #
    def _nbv_put(
        self, mover, xs: Sequence[torch.Tensor], meta: torch.Tensor
    ) -> Tuple[List[Pending], Pending]:
        xs = list(xs)
        if not xs:
            raise ValueError("vectored put needs at least one payload")
        meta = meta.to(torch.int32).reshape(-1)
        if xs[0].element_size() == 4:
            # the int32 command block bitcasts into the payload carrier, so
            # payloads AND their target offsets ride ONE transport
            # initiation; the bits arrive unchanged (NaN patterns included).
            mcarrier = transport.bitcast(meta, xs[0].dtype)
            pendings = mover(xs + [mcarrier])
            return pendings[:-1], pendings[-1]
        # non-4-byte carriers: the command block rides its own initiation
        # (still 2 α for m puts instead of 3m).
        payload = mover(xs)
        (mp,) = mover([meta])
        return payload, mp

    def shift_nbv_put(
        self, xs: Sequence[torch.Tensor], meta: torch.Tensor, k: int = 1
    ) -> Tuple[List[Pending], Pending]:
        """Vectored put transport to node ``(me + k) % n``: ``xs`` are the m
        payload vectors and ``meta`` the int32 *command block* (target
        offsets + arrival flags) — shipped together in one initiation when
        the payload dtype is 4 bytes wide.  Returns ``(payload_pendings,
        meta_pending)``; the meta pending completes to the carrier dtype and
        the caller bitcasts it back."""
        return self._nbv_put(lambda v: self.shift_nbv(v, k), xs, meta)

    def permute_nbv_put(
        self, xs: Sequence[torch.Tensor], meta: torch.Tensor,
        dst: Sequence[int],
    ) -> Tuple[List[Pending], Pending]:
        """Vectored put transport along a permutation (see
        :meth:`shift_nbv_put`)."""
        return self._nbv_put(lambda v: self.permute_nbv(v, dst), xs, meta)

    # -- collectives ----------------------------------------------------- #
    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x: (n_nodes * m, ...) tiled exchange along dim 0.

        Default implementation: the fully overlapped split-phase exchange
        (``collectives.exchange``).  Engines with a native all-to-all
        override this."""
        from repro_torch.core import collectives

        return collectives.exchange(self, x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x: local (m, ...) -> (n_nodes * m, ...)."""
        raise NotImplementedError

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """x: (n_nodes * m, ...) -> summed local (m, ...)."""
        raise NotImplementedError

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # -- control ---------------------------------------------------------- #
    def my_id(self) -> torch.Tensor:
        if self.ids is None:
            raise RuntimeError(
                f"engine {self.name!r} has no rank ids: transport runs "
                "inside Context.spmd"
            )
        return self.ids

    def barrier(self, token: Optional[torch.Tensor] = None) -> torch.Tensor:
        """GASNet barrier.  In bulk-synchronous SPMD a barrier is implied by
        any collective; kept for API fidelity as the sum over ranks of a
        unit token (``lax.psum``), which launches no kernel."""
        ids = self.my_id()
        t = torch.ones((), dtype=torch.int32, device=ids.device) if (
            token is None) else token
        return transport.all_reduce(t, ids, self.n_nodes)


class XlaEngine(CommEngine):
    """Software GASNet node: PyTorch indexing as the transport."""

    name = "xla"
    can_permute_partial = True

    def shift(self, x: torch.Tensor, k: int = 1) -> torch.Tensor:
        if k % self.n_nodes == 0:
            return x
        return transport.shift(x, self.my_id(), k % self.n_nodes,
                               self.n_nodes, "xla")

    def permute(self, x: torch.Tensor, dst: Sequence[int]) -> torch.Tensor:
        d = [-1 if v is None else int(v) for v in dst]
        return transport.permute(x, self.my_id(), d, self.n_nodes, "xla")

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return transport.all_to_all(x, self.my_id(), self.n_nodes)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return transport.all_gather(x, self.my_id(), self.n_nodes, "xla")

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        return transport.reduce_scatter(x, self.my_id(), self.n_nodes, "xla")

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return transport.all_reduce(x, self.my_id(), self.n_nodes)


class GascoreEngine(CommEngine):
    """Hardware GASNet node: the hand-written CUDA kernels (GAScore) as the
    transport — one launch per transfer for all ranks."""

    name = "gascore"

    def shift(self, x: torch.Tensor, k: int = 1) -> torch.Tensor:
        if k % self.n_nodes == 0:
            return x
        return transport.shift(x, self.my_id(), k % self.n_nodes,
                               self.n_nodes, "gascore")

    def permute(self, x: torch.Tensor, dst: Sequence[int]) -> torch.Tensor:
        d = [int(v) for v in dst]  # None -> TypeError: bijections only
        return transport.permute(x, self.my_id(), d, self.n_nodes, "gascore")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return transport.all_gather(x, self.my_id(), self.n_nodes, "gascore")

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        return transport.reduce_scatter(x, self.my_id(), self.n_nodes,
                                        "gascore")

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        # RS + AG when the leading dim tiles evenly; otherwise a shift-and-
        # accumulate ring (n-1 hops carrying the full tensor).
        lead = x.shape[0] if x.dim() else 0
        if x.dim() and lead % self.n_nodes == 0 and lead > 0:
            return self.all_gather(self.reduce_scatter(x))
        acc = x
        cur = x
        for _ in range(self.n_nodes - 1):
            cur = self.shift(cur, 1)
            acc = acc + cur
        return acc

    # all_to_all: inherited split-phase exchange over shift_nb.


class EngineMap(CommEngine):
    """Heterogeneous node map: each rank is backed by its own engine.

    ``backends[r]`` names the engine serving rank ``r`` (``"xla"`` =
    software node, ``"gascore"`` = hardware node).  Point-to-point transport
    is carried *per edge* by the sender's engine: every member engine moves
    the payload (so a mixed run both launches the kernels and uses the
    indexing path), and each receiver keeps the copy delivered by its
    sender's backend.  Collectives are the ring/put algorithms from
    ``repro_torch.core.collectives`` over that mixed edge transport.

    A partial permute (``None`` destinations) is only legal when every
    member engine supports it.
    """

    name = "map"

    def __init__(
        self,
        axis: str,
        backends: Sequence[str],
        ids: Optional[torch.Tensor] = None,
    ):
        super().__init__(axis, len(backends), ids)
        self.backends = tuple(backends)
        uniq: List[str] = []
        for b in self.backends:
            if b not in uniq:
                uniq.append(b)
        self._engines = {
            b: _make_single_engine(b, axis, self.n_nodes, ids) for b in uniq
        }
        self._uniq = tuple(uniq)
        self._masks: dict = {}  # backend -> (n,) bool on the ids' device
        self.can_permute_partial = all(
            self._engines[b].can_permute_partial for b in self._uniq
        )

    def backend_of(self, rank: int) -> str:
        return self.backends[rank % self.n_nodes]

    def member(self, backend: str) -> CommEngine:
        return self._engines[backend]

    @property
    def is_heterogeneous(self) -> bool:
        return len(self._uniq) > 1

    def _mask(self, backend: str) -> torch.Tensor:
        m = self._masks.get(backend)
        if m is None:
            m = torch.tensor([be == backend for be in self.backends],
                             device=self.my_id().device)
            self._masks[backend] = m
        return m

    # -- per-edge transport selection ----------------------------------- #
    def _select_by_src(self, outs: dict, src: torch.Tensor) -> torch.Tensor:
        """Each receiver keeps the copy carried by its *sender's* engine."""
        acc = outs[self._uniq[0]]
        for b in self._uniq[1:]:
            acc = torch.where(self._mask(b)[src.long()], outs[b], acc)
        return acc

    def shift(self, x: torch.Tensor, k: int = 1) -> torch.Tensor:
        if k % self.n_nodes == 0:
            return x
        if not self.is_heterogeneous:
            return self._engines[self._uniq[0]].shift(x, k)
        outs = {b: self._engines[b].shift(x, k) for b in self._uniq}
        src = torch.remainder(self.my_id() - k + 2 * self.n_nodes, self.n_nodes)
        return self._select_by_src(outs, src)

    def permute(self, x: torch.Tensor, dst: Sequence[int]) -> torch.Tensor:
        if not self.is_heterogeneous:
            return self._engines[self._uniq[0]].permute(x, dst)
        has_none = any(d is None for d in dst)
        if has_none and not self.can_permute_partial:
            raise ValueError(
                "partial permute (None destinations) unsupported by "
                f"engine map {self.backends}"
            )
        outs = {b: self._engines[b].permute(x, dst) for b in self._uniq}
        # receiver j's sender is inv[j]; non-destinations receive zeros
        # from every member engine, so any branch is correct for them.
        inv = [0] * self.n_nodes
        for s, d in enumerate(dst):
            if d is not None:
                inv[int(d)] = s
        ids = self.my_id()
        src = torch.tensor(inv, dtype=torch.int32, device=ids.device)[ids.long()]
        return self._select_by_src(outs, src)

    # -- collectives: the put algorithms over the mixed edge transport --- #
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.core import collectives

        return collectives.ring_all_gather(self, x)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.core import collectives

        return collectives.ring_reduce_scatter(self, x)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        from repro_torch.core import collectives

        return collectives.ring_all_reduce(self, x)

    # all_to_all: inherited split-phase exchange over shift_nb.


def _make_single_engine(
    backend: str, axis: str, n_nodes: int, ids: Optional[torch.Tensor] = None
) -> CommEngine:
    if backend == "xla":
        return XlaEngine(axis, n_nodes, ids)
    if backend == "gascore":
        return GascoreEngine(axis, n_nodes, ids)
    raise ValueError(f"unknown engine backend {backend!r}")


def parse_backend_spec(backend, n_nodes: int) -> Tuple[str, ...]:
    """Normalize a backend spec to one name per rank.

    Accepts a single name (``"xla"``), a comma-separated per-rank pattern
    (``"xla,gascore"`` — tiled around the ring when shorter than
    ``n_nodes``), or a sequence of names.
    """
    if isinstance(backend, str):
        names = [b.strip() for b in backend.split(",") if b.strip()]
    else:
        names = [str(b) for b in backend]
    if not names:
        raise ValueError("empty engine backend spec")
    if n_nodes % len(names):
        raise ValueError(
            f"backend pattern {names} (len {len(names)}) does not tile "
            f"{n_nodes} nodes"
        )
    return tuple(names[i % len(names)] for i in range(n_nodes))


def make_engine(
    backend, axis: str, n_nodes: int, ids: Optional[torch.Tensor] = None
) -> CommEngine:
    """Build the engine (or heterogeneous :class:`EngineMap`) for the rank
    axis.

    ``backend`` is a single engine name, a comma-separated per-rank pattern,
    or a sequence of per-rank names — ``make_engine("xla,gascore", ...)``
    gives alternating software/hardware nodes, the paper's mixed cluster.
    ``ids`` are the batched rank ids inside ``Context.spmd``.
    """
    ranks = parse_backend_spec(backend, n_nodes)
    uniq = set(ranks)
    if len(uniq) == 1:
        return _make_single_engine(ranks[0], axis, n_nodes, ids)
    return EngineMap(axis, ranks, ids=ids)
