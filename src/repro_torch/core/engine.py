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

Split phase on the card: the ``*_nb`` methods enqueue their transport on a
per-device *side stream* that first waits on the current stream (so the
producers of the payload come first), and record a CUDA event after it;
``Pending.wait()`` makes the current stream wait on that event.  Neither
step waits on the host, and compute issued between initiation and wait
runs on the current stream beside the transfer.  On the CPU there is no
stream: initiation runs the transfer, ``wait()`` returns it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.compat import device_const
from repro_torch.core import transport

__all__ = [
    "CommEngine",
    "Pending",
    "AlreadyWaitedError",
    "wait_all",
    "XlaEngine",
    "GascoreEngine",
    "EngineMap",
    "GroupEngine",
    "pod_engines",
    "make_engine",
    "parse_backend_spec",
    "side_stream",
]

# device index -> the side stream split-phase transfers run on
_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream this process's split-phase transfers on ``device`` run
    on, made at first use and kept (one per device, shared by every
    engine, so an :class:`EngineMap`'s members queue on one stream)."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    s = _SIDE_STREAMS.get(idx)
    if s is None:
        s = _SIDE_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return s


class AlreadyWaitedError(RuntimeError):
    """A split-phase handle was synced twice.

    A transfer completes exactly once (``gasnet_wait_syncnb`` semantics);
    the message always names the offending op so batch waits
    (:func:`wait_all`, ``node.sync_all``) are debuggable.
    """


class Pending:
    """An in-flight transport operation (the engine half of split-phase).

    ``shift_nb``/``permute_nb`` return a ``Pending`` at *initiation*;
    ``wait()`` is the *sync point* that yields the delivered value.  On
    the card the transfer was enqueued on the side stream
    (:func:`side_stream`) and an event recorded after it (``events``, one
    per engine that moved it); ``wait()`` makes the current stream wait
    on them, so work issued after it sees the data, and the host never
    waits.  Compute issued between initiation and ``wait()`` runs beside
    the transfer.  ``events`` is empty on the CPU.

    ``finish`` (optional) runs at the wait on the delivered value, on the
    current stream: an :class:`EngineMap` selects each receiver's copy
    there, once every member's event has been waited on.

    ``op`` labels the operation for error messages (``shift(k=1)``,
    ``permute``, ...), so a double-wait names the op.
    """

    __slots__ = ("_value", "_waited", "op", "events", "_finish")

    def __init__(self, value, op: str = "transfer",
                 events: Sequence[torch.cuda.Event] = (),
                 finish: Optional[Callable] = None):
        self._value = value
        self._waited = False
        self.op = op
        self.events = tuple(events)
        self._finish = finish

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
        for ev in self.events:
            torch.cuda.current_stream().wait_event(ev)
        value = self._value
        if self._finish is not None:
            value = self._finish(value)
        self._value = None
        return value

    def ready(self) -> bool:
        """Poll (``gasnet_try_syncnb``): True, as in the reference.  The
        static SPMD schedule delivers every initiated transfer, and
        ``wait()`` orders the streams on the device without the host
        waiting, so a handle can always be completed."""
        return True


def _split_phase(ids: torch.Tensor, move: Callable, op: str) -> Pending:
    """Initiate ``move()`` (one transport op) split-phase: on the card on
    the side stream after it waits on the current stream, an event
    recorded behind it; on the CPU in line."""
    if ids.device.type != "cuda":
        return Pending(move(), op=op)
    main = torch.cuda.current_stream(ids.device)
    side = side_stream(ids.device)
    side.wait_stream(main)  # the payload's producers come first
    with torch.cuda.stream(side), transport.on_side_stream(side, main):
        value = move()
    ev = torch.cuda.Event()
    ev.record(side)
    return Pending(value, op=op, events=(ev,))


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
        node ``(me + k) % n`` (on the card: on the side stream) and return
        a :class:`Pending` whose ``wait()`` is the sync point."""
        return _split_phase(self.my_id(), lambda: self.shift(x, k),
                            f"shift(k={k})")

    def permute_nb(self, x: torch.Tensor, dst: Sequence[int]) -> Pending:
        """Non-blocking :meth:`permute` (split-phase, see :meth:`shift_nb`)."""
        return _split_phase(self.my_id(), lambda: self.permute(x, dst),
                            "permute")

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
        self, moved: Pending, xs: Sequence[torch.Tensor], op: str
    ) -> List[Pending]:
        """One :class:`Pending` per payload of a vectored move, each
        completing through the move's events to its static slice."""
        done: List[torch.Tensor] = []

        def whole(_):
            if not done:  # the move completes once for all its payloads
                v = moved._value
                done.append(v if moved._finish is None else moved._finish(v))
            return done[0]

        out: List[Pending] = []
        offset = 0
        for x in xs:
            def piece(_, lo=offset, x=x):
                return whole(None)[lo : lo + x.numel()].reshape(x.shape)

            out.append(Pending(None, op=op, events=moved.events, finish=piece))
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
        moved = self.shift_nb(self._pack_nbv(xs), k)
        return self._unpack_nbv(moved, xs, op=f"shiftv(k={k})")

    def permute_nbv(
        self, xs: Sequence[torch.Tensor], dst: Sequence[int]
    ) -> List[Pending]:
        """Vectored non-blocking :meth:`permute` (see :meth:`shift_nbv`)."""
        xs = list(xs)
        if not xs:
            return []
        moved = self.permute_nb(self._pack_nbv(xs), dst)
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
        return device_const([be == backend for be in self.backends],
                            torch.bool, self.my_id().device)

    # -- per-edge transport selection ----------------------------------- #
    def _select_by_src(self, outs: dict, src: torch.Tensor) -> torch.Tensor:
        """Each receiver keeps the copy carried by its *sender's* engine."""
        acc = outs[self._uniq[0]]
        for b in self._uniq[1:]:
            acc = torch.where(self._mask(b)[src.long()], outs[b], acc)
        return acc

    def _shift_src(self, k: int) -> torch.Tensor:
        return torch.remainder(self.my_id() - k + 2 * self.n_nodes,
                               self.n_nodes)

    def _permute_src(self, dst: Sequence[int]) -> torch.Tensor:
        has_none = any(d is None for d in dst)
        if has_none and not self.can_permute_partial:
            raise ValueError(
                "partial permute (None destinations) unsupported by "
                f"engine map {self.backends}"
            )
        # receiver j's sender is inv[j]; non-destinations receive zeros
        # from every member engine, so any branch is correct for them.
        inv = [0] * self.n_nodes
        for s, d in enumerate(dst):
            if d is not None:
                inv[int(d)] = s
        ids = self.my_id()
        return device_const(inv, torch.int32, ids.device)[ids.long()]

    def shift(self, x: torch.Tensor, k: int = 1) -> torch.Tensor:
        if k % self.n_nodes == 0:
            return x
        if not self.is_heterogeneous:
            return self._engines[self._uniq[0]].shift(x, k)
        outs = {b: self._engines[b].shift(x, k) for b in self._uniq}
        return self._select_by_src(outs, self._shift_src(k))

    def permute(self, x: torch.Tensor, dst: Sequence[int]) -> torch.Tensor:
        if not self.is_heterogeneous:
            return self._engines[self._uniq[0]].permute(x, dst)
        src = self._permute_src(dst)
        outs = {b: self._engines[b].permute(x, dst) for b in self._uniq}
        return self._select_by_src(outs, src)

    # -- split phase: every member moves on the shared side stream; the
    # select runs at the wait, after every member's event ---------------- #
    def _map_nb(self, pendings: dict, src: torch.Tensor, op: str) -> Pending:
        def select(_):
            return self._select_by_src(
                {b: p._value for b, p in pendings.items()}, src)

        events = tuple(ev for p in pendings.values() for ev in p.events)
        return Pending(None, op=op, events=events, finish=select)

    def shift_nb(self, x: torch.Tensor, k: int = 1) -> Pending:
        if k % self.n_nodes == 0 or not self.is_heterogeneous:
            return super().shift_nb(x, k)
        pendings = {b: self._engines[b].shift_nb(x, k) for b in self._uniq}
        return self._map_nb(pendings, self._shift_src(k), f"shift(k={k})")

    def permute_nb(self, x: torch.Tensor, dst: Sequence[int]) -> Pending:
        if not self.is_heterogeneous:
            return super().permute_nb(x, dst)
        src = self._permute_src(dst)
        pendings = {b: self._engines[b].permute_nb(x, dst) for b in self._uniq}
        return self._map_nb(pendings, src, "permute")

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


class GroupEngine(CommEngine):
    """One collective's view of a base engine whose ranks are cut into
    equal groups: the reference's second mesh axis on the port's one
    rank axis.

    ``groups`` partitions the base ranks; ``groups[g][i]`` is the base
    rank at index ``i`` of group ``g``.  ``my_id`` is a rank's index in
    its group and ``n_nodes`` the group size, so the ring algorithms of
    ``collectives`` run unchanged, every group its own ring.  A move is
    ONE move of the base engine over all ranks along a static bijection
    that stays inside each group: a uniform shift of the base ranks goes
    to ``base.shift`` (``ring_shift`` on "gascore"), any other pattern to
    ``base.permute`` (``perm_put``).  An :class:`EngineMap` base keeps its
    per-edge selection.  The engine's collectives are the put rings; the
    fused GAScore collectives span every rank and are not used."""

    def __init__(self, base: CommEngine, groups: Sequence[Sequence[int]],
                 axis: Optional[str] = None):
        groups = tuple(tuple(int(r) for r in g) for g in groups)
        n = base.n_nodes
        m = len(groups[0]) if groups else 0
        if (not m or any(len(g) != m for g in groups)
                or sorted(r for g in groups for r in g) != list(range(n))):
            raise ValueError(
                f"groups {groups} are not a partition of {n} ranks into "
                "equal groups")
        super().__init__(axis or base.axis, m, base.ids)
        self.base = base
        self.groups = groups
        self.name = base.name
        self.can_permute_partial = base.can_permute_partial
        self._index = [0] * n
        self._group = [0] * n
        for g, members in enumerate(groups):
            for i, r in enumerate(members):
                self._index[r], self._group[r] = i, g

    def my_id(self) -> torch.Tensor:
        ids = self.base.my_id()
        return device_const(self._index, torch.int32, ids.device)[ids.long()]

    def barrier(self, token: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The base axis's barrier (one over all ranks orders the group)."""
        return self.base.barrier(token)

    def _lift(self, dst: Sequence[Optional[int]]) -> List[Optional[int]]:
        """Group-local destinations as base-rank destinations."""
        return [
            None if dst[self._index[r]] is None
            else self.groups[self._group[r]][int(dst[self._index[r]])]
            for r in range(self.base.n_nodes)
        ]

    def _uniform(self, k: int) -> Tuple[List[Optional[int]], Optional[int]]:
        """The base destinations of a shift by ``k`` in every group, and
        the base shift they amount to (None when they are not one)."""
        glob = self._lift([(i + k) % self.n_nodes for i in range(self.n_nodes)])
        n = self.base.n_nodes
        s = glob[0]
        return glob, s if all(d == (r + s) % n for r, d in enumerate(glob)) else None

    def shift(self, x: torch.Tensor, k: int = 1) -> torch.Tensor:
        if k % self.n_nodes == 0:
            return x
        glob, s = self._uniform(k)
        return self.base.shift(x, s) if s is not None else self.base.permute(x, glob)

    def permute(self, x: torch.Tensor, dst: Sequence[int]) -> torch.Tensor:
        return self.base.permute(x, self._lift(dst))

    def shift_nb(self, x: torch.Tensor, k: int = 1) -> Pending:
        if k % self.n_nodes == 0:
            return Pending(x, op=f"shift(k={k})")
        glob, s = self._uniform(k)
        if s is not None:
            return self.base.shift_nb(x, s)
        return self.base.permute_nb(x, glob)

    def permute_nb(self, x: torch.Tensor, dst: Sequence[int]) -> Pending:
        return self.base.permute_nb(x, self._lift(dst))

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


def pod_engines(base: CommEngine, n_pods: int) -> Tuple[GroupEngine, GroupEngine]:
    """``(inner, outer)`` group engines of a ``(n_pods, n_inner)`` grid laid
    over the base ranks pod-major (rank ``p * n_inner + i``), as the
    reference's ``(pod, data)`` mesh lays out its devices: ``inner``
    enumerates the ranks of a pod, ``outer`` the pods a rank's index
    meets in."""
    n = base.n_nodes
    if n_pods < 1 or n % n_pods:
        raise ValueError(f"{n_pods} pods do not tile {n} ranks")
    m = n // n_pods
    inner = GroupEngine(base, [range(p * m, (p + 1) * m)
                               for p in range(n_pods)], axis="data")
    outer = GroupEngine(base, [range(i, n, m) for i in range(m)], axis="pod")
    return inner, outer


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
