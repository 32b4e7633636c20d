"""GASNet-style API surface: contexts, nodes, one-sided put/get, AMs.

This is the unified API the paper argues for: the *same* calls are made by
"software nodes" and "hardware nodes"; only the engine differs.  Mapping to
GASNet Core and Extended:

======================  ===================================================
GASNet Core              here
======================  ===================================================
gasnet_init/attach       ``Context(n_nodes, backend=..., device=...)`` + AddressSpace
gasnet_mynode            ``node.my_id``
gasnet_nodes             ``node.n_nodes``
gasnet_put               ``node.put(seg, data, to=..., index=...)``
gasnet_get               ``node.get(seg, frm=..., index=..., size=...)``
gasnet_AMRequestShort    ``node.am_short(dest, handler, args)``
gasnet_AMRequestMedium   ``node.am_medium(dest, handler, payload, args)``
gasnet_AMRequestLong     ``node.am_long(dest, handler, payload, dst_index)``
gasnet_AMReplyShort      handler returns ``am.reply_short(...)`` (see below)
gasnet_AMReplyMedium     handler returns ``am.reply_medium(...)``
(request expecting ack)  ``node.am_call(dest, handler, ..., ack=fetch)``
(poll + handler run)     ``node.am_flush(state)`` — two hops when the
                         table has ``replies=True`` handlers
gasnet_barrier           ``node.barrier()``
======================  ===================================================

======================  ===================================================
GASNet Extended          here (split-phase, see ``repro_torch.core.extended``)
======================  ===================================================
gasnet_put_nb            ``node.put_nb(seg, data, to=..., index=...)``
gasnet_get_nb            ``node.get_nb(seg, frm=..., index=..., size=...)``
(vector get, one α)      ``node.get_nbv(seg, frm=..., indices=[...],
                         size=...)`` — m fetches per request/reply pair
(vector put, one α)      ``node.put_nbv(seg, datas, to=...,
                         indices=[...])`` — m writes + their target
                         offsets in one command block
gasnet_wait_syncnb       ``node.sync(handle)``
(landing by the caller)  ``node.defer(handle)`` + ``extended.land(...)``
gasnet_try_syncnb        ``node.try_sync(handle)``
gasnet_wait_syncnb_all   ``node.sync_all()``
======================  ===================================================

One-sided semantics under SPMD: every node executes the same program, so a
"one-sided put" is a *pattern* of puts — :class:`Shift` (every node targets
``me+k``) or :class:`Perm` (arbitrary static permutation).  Data-dependent
destinations go through the Active Message router (capacity-bounded
all-to-all), the static-schedule analogue of the paper's packet network.

All ranks live on one device (CUDA by default).  ``Context.spmd`` lifts a
node program over the rank axis with ``torch.func.vmap`` — the port's
``shard_map`` — so every rank sees its ``(1, *local)`` partition and every
transfer is one transport op for all ranks (``core.transport``).

Example::

    ctx = gasnet.Context(8, backend="gascore")
    aspace = ctx.address_space()
    aspace.register("buf", (128,), torch.float32)
    seg = aspace.alloc("buf")

    def program(node, seg):
        seg = node.put(seg, node.local(seg)[:16], to=gasnet.Shift(1), index=0)
        node.barrier()
        return seg

    seg = ctx.spmd(program, seg)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
from torch.func import vmap

from repro_torch import compat
from repro_torch.core import am as am_lib
from repro_torch.core import extended
from repro_torch.core.addrspace import AddressSpace, P
from repro_torch.core.engine import CommEngine, make_engine
from repro_torch.core.indexing import as_i32, dynamic_slice
from repro_torch.kernels import cost
from repro_torch.obs import trace as obs_trace

__all__ = ["Shift", "Perm", "Context", "Node", "P"]


@dataclasses.dataclass(frozen=True)
class Shift:
    """Every node targets node ``(me + k) % n``."""

    k: int = 1


@dataclasses.dataclass(frozen=True)
class Perm:
    """Node ``i`` targets node ``dst[i]`` (a static permutation)."""

    dst: Tuple[int, ...]


Pattern = Any  # Shift | Perm


def _inverse(pattern: Pattern, n: int) -> Pattern:
    if isinstance(pattern, Shift):
        return Shift(-pattern.k)
    inv = [0] * n
    for s, d in enumerate(pattern.dst):
        inv[int(d)] = s
    return Perm(tuple(inv))


class Node:
    """Handle passed to SPMD node programs; wraps one CommEngine.

    Segments appear as their local ``(1, *local_shape)`` partitions inside
    ``Context.spmd`` (one rank's view under vmap).
    """

    def __init__(self, engine: CommEngine, handlers: am_lib.HandlerTable,
                 am_capacity: int, am_payload_width: int,
                 am_per_peer_capacity: int):
        self.engine = engine
        self.handlers = handlers
        self._am_capacity = am_capacity
        self._am_payload_width = am_payload_width
        self._am_per_peer = am_per_peer_capacity
        self._batch: Optional[am_lib.AMBatch] = None
        self._outstanding: list[extended.Handle] = []
        self._pending_acks: list[extended.AckHandle] = []
        # id(seg) -> latest synced local partition, so several outstanding
        # puts against the same segment object chain instead of each
        # applying to the stale snapshot taken at initiation.  Pinning the
        # seg objects keeps the ids stable for the node's lifetime.
        self._seg_latest: dict[int, torch.Tensor] = {}
        self._seg_pins: list[torch.Tensor] = []
        self.dropped = torch.zeros((), dtype=torch.int32,
                                   device=engine.my_id().device)

    # ----------------------------------------------------------------- #
    # identity & sync
    # ----------------------------------------------------------------- #
    @property
    def my_id(self) -> torch.Tensor:
        return self.engine.my_id()

    @property
    def n_nodes(self) -> int:
        return self.engine.n_nodes

    def barrier(self) -> None:
        self.engine.barrier()

    # ----------------------------------------------------------------- #
    # segments: local views
    # ----------------------------------------------------------------- #
    @staticmethod
    def local(seg: torch.Tensor) -> torch.Tensor:
        """Local partition of a segment inside ``Context.spmd``: drop the
        leading per-node axis of size 1."""
        return seg[0]

    @staticmethod
    def _restore(seg_like: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
        del seg_like
        return local[None]

    # ----------------------------------------------------------------- #
    # one-sided remote memory access
    # ----------------------------------------------------------------- #
    def _move(self, x: torch.Tensor, to: Pattern) -> torch.Tensor:
        if isinstance(to, Shift):
            return self.engine.shift(x, to.k)
        if isinstance(to, Perm):
            return self.engine.permute(x, to.dst)
        raise TypeError(f"bad pattern {to!r}")

    def _move_nb(self, x: torch.Tensor, to: Pattern):
        """Split-phase move (``CommEngine.shift_nb``/``permute_nb``):
        returns the Pending."""
        if isinstance(to, Shift):
            return self.engine.shift_nb(x, to.k)
        if isinstance(to, Perm):
            return self.engine.permute_nb(x, to.dst)
        raise TypeError(f"bad pattern {to!r}")

    def _move_nbv(self, xs: Sequence[torch.Tensor], to: Pattern) -> list:
        """Vectored split-phase move: one transport initiation for all of
        ``xs`` (see ``CommEngine.shift_nbv``); returns the Pendings."""
        if isinstance(to, Shift):
            return self.engine.shift_nbv(xs, to.k)
        if isinstance(to, Perm):
            return self.engine.permute_nbv(xs, to.dst)
        raise TypeError(f"bad pattern {to!r}")

    def put(
        self,
        seg: torch.Tensor,
        data: torch.Tensor,
        *,
        to: Pattern = Shift(1),
        index: torch.Tensor | int = 0,
        pred: torch.Tensor | bool | None = None,
    ) -> torch.Tensor:
        """One-sided remote write: ``data`` lands in the target node's
        partition of ``seg`` at flat offset ``index`` (sender-specified,
        shipped with the payload, exactly like a GAScore AMLong header).

        Returns the updated segment.  ``data`` is flattened; the write is
        contiguous in the flattened local partition.

        Blocking = ``put_nb`` + immediate ``sync`` (GASNet defines
        ``gasnet_put`` exactly this way).
        """
        return self.sync(self.put_nb(seg, data, to=to, index=index, pred=pred))

    def get(
        self,
        seg: torch.Tensor,
        *,
        frm: Pattern = Shift(1),
        index: torch.Tensor | int = 0,
        size: int = 1,
    ) -> torch.Tensor:
        """One-sided remote read of ``size`` flat elements at offset
        ``index`` in node ``pattern(me)``'s partition.

        GASNet gets are request/reply; so is this: the offset travels to the
        source (inverse pattern), the source slices, the reply travels back.
        Blocking = ``get_nb`` + immediate ``sync``.
        """
        return self.sync(self.get_nb(seg, frm=frm, index=index, size=size))

    # ----------------------------------------------------------------- #
    # Extended API: split-phase non-blocking RMA (see repro_torch.core.extended)
    # ----------------------------------------------------------------- #
    def put_nb(
        self,
        seg: torch.Tensor,
        data: torch.Tensor,
        *,
        to: Pattern = Shift(1),
        index: torch.Tensor | int = 0,
        pred: torch.Tensor | bool | None = None,
    ) -> extended.PutHandle:
        """Initiate a non-blocking one-sided put (``gasnet_put_nb``).

        The payload, target offset and arrival flag are shipped at the call
        (transport initiation); the returned handle lands them in the
        segment when synced: ``seg = node.sync(h)``.  Compute issued
        between the two does not depend on the transfer and runs beside
        it (the transfer is on the engine's side stream).

        ``pred`` gates the write (SPMD conditional put): every rank runs
        the same transfer, but a rank passing ``pred=False`` ships a
        cleared arrival flag, so the receiver keeps its current contents —
        the static-schedule analogue of simply not issuing the put.
        """
        local = self.local(seg)
        dev = self.my_id.device
        payload = data.reshape(-1).to(local.dtype)
        idx = as_i32(index, dev)
        flag = _bool(pred, dev)
        moved = self._move_nb(payload, to)
        midx = self._move_nb(idx, to)
        received = self._move_nb(flag, to)
        self._seg_pins.append(seg)
        h = extended.PutHandle(
            local, moved, midx, received,
            functools.partial(self._restore, seg),
            key=id(seg),
        )
        tr = obs_trace.active()
        if tr.enabled:
            h.span = tr.begin_async(
                "put_nb", cat="rma",
                bytes=int(payload.numel()) * payload.element_size(),
                engine=self.engine.name, seg=id(seg),
                pred=pred is not None,
            )
        self._outstanding.append(h)
        return h

    def get_nb(
        self,
        seg: torch.Tensor,
        *,
        frm: Pattern = Shift(1),
        index: torch.Tensor | int = 0,
        size: int = 1,
    ) -> extended.GetHandle:
        """Initiate a non-blocking one-sided get (``gasnet_get_nb``).

        Request and reply legs are both initiated here; ``node.sync(h)``
        returns the fetched ``(size,)`` vector.
        """
        n = self.n_nodes
        inv = _inverse(frm, n)
        local = self.local(seg).reshape(-1)
        idx = as_i32(index, self.my_id.device)
        # request: the source node pattern(me) learns the offset I want
        req = self._move(idx, frm)
        data = dynamic_slice(local, req, size)
        # reply: data travels back from the source to me
        h = extended.GetHandle(self._move_nb(data, inv))
        tr = obs_trace.active()
        if tr.enabled:
            h.span = tr.begin_async(
                "get_nb", cat="rma",
                bytes=size * local.element_size(),
                engine=self.engine.name, seg=id(seg), pred=False,
            )
        self._outstanding.append(h)
        return h

    def put_nbv(
        self,
        seg: torch.Tensor,
        datas: Any,
        *,
        to: Pattern = Shift(1),
        indices: torch.Tensor | Sequence[int],
        pred: torch.Tensor | bool | Sequence[Any] | None = None,
    ) -> extended.PutvHandle:
        """Initiate a vectored non-blocking put (``gasnet_put_nbv``): land
        ``m = len(indices)`` equally-sized payloads at flat offsets
        ``indices`` of node ``pattern(me)``'s partition, as ONE vectored
        transport — the write-side mirror of :meth:`get_nbv`.

        ``datas`` is an ``(m, size)`` stack or a sequence of m equal-length
        vectors.  Payloads and the int32 *command block* (offsets + arrival
        flags) ride the engine's vectored put transport
        (``shift_nbv_put``/``permute_nbv_put``): m writes cost one
        initiation α instead of 3m — a GAScore command FIFO drained as a
        single wire message.  Callers batching many page writes (e.g. KV
        swap-out to a memory rank) pick the batch size with
        ``sched.plan_p2p`` on the total byte count.

        ``pred`` gates the writes SPMD-conditionally: a scalar gates the
        whole batch, a length-m vector gates per payload — a cleared flag
        ships its payload anyway (static schedule) but the receiver keeps
        its current bytes at that offset.  ``seg = node.sync(h)`` lands the
        flagged payloads; outstanding puts on the same segment compose.
        """
        local = self.local(seg)
        dev = self.my_id.device
        if isinstance(datas, (list, tuple)):
            payloads = [torch.as_tensor(d, device=dev).reshape(-1)
                        for d in datas]
        else:
            datas = torch.as_tensor(datas, device=dev)
            payloads = [datas[j].reshape(-1) for j in range(datas.shape[0])]
        m = len(payloads)
        if m == 0:
            raise ValueError("put_nbv needs at least one payload")
        sizes = {int(p.shape[0]) for p in payloads}
        if len(sizes) != 1:
            raise ValueError(
                f"put_nbv payloads must share one size, got {sorted(sizes)}"
            )
        payloads = [p.to(local.dtype) for p in payloads]
        idxs = as_i32(indices, dev).reshape(-1)
        if int(idxs.shape[0]) != m:
            raise ValueError(
                f"put_nbv got {m} payloads but {int(idxs.shape[0])} indices"
            )
        if pred is None:
            flags = torch.ones((m,), dtype=torch.int32, device=dev)
        else:
            # a per-payload list may mix Python bools and (batched) tensors
            flags = (torch.stack([_bool(p, dev) for p in pred])
                     if isinstance(pred, (list, tuple))
                     else torch.as_tensor(pred, device=dev))
            if flags.dim() == 0:
                flags = flags.expand((m,))
            flags = flags.to(torch.int32).reshape(-1)
            if int(flags.shape[0]) != m:
                raise ValueError(
                    f"put_nbv pred must be scalar or length {m}"
                )
        meta = torch.cat([idxs, flags])
        if isinstance(to, Shift):
            pp, mp = self.engine.shift_nbv_put(payloads, meta, to.k)
        elif isinstance(to, Perm):
            pp, mp = self.engine.permute_nbv_put(payloads, meta, to.dst)
        else:
            raise TypeError(f"bad pattern {to!r}")
        self._seg_pins.append(seg)
        h = extended.PutvHandle(
            local, pp, mp,
            functools.partial(self._restore, seg),
            key=id(seg),
        )
        tr = obs_trace.active()
        if tr.enabled:
            size = payloads[0].shape[0]
            h.span = tr.begin_async(
                "put_nbv", cat="rma",
                bytes=m * size * local.element_size(),
                m=m, engine=self.engine.name, seg=id(seg),
                pred=pred is not None,
            )
        self._outstanding.append(h)
        return h

    def put_v(
        self,
        seg: torch.Tensor,
        datas: Any,
        *,
        to: Pattern = Shift(1),
        indices: torch.Tensor | Sequence[int],
        pred: torch.Tensor | bool | Sequence[Any] | None = None,
    ) -> torch.Tensor:
        """Blocking vectored put: ``put_nbv`` + immediate ``sync``."""
        return self.sync(
            self.put_nbv(seg, datas, to=to, indices=indices, pred=pred)
        )

    def get_nbv(
        self,
        seg: torch.Tensor,
        *,
        frm: Pattern = Shift(1),
        indices: torch.Tensor | Sequence[int],
        size: int = 1,
        pred: torch.Tensor | bool | None = None,
    ) -> extended.GetvHandle:
        """Initiate a vectored non-blocking get (``gasnet_get_nbv``): fetch
        ``m = len(indices)`` slices of ``size`` flat elements each from
        node ``pattern(me)``'s partition, as ONE request/reply pair.

        Both legs ride the engine's *vectored* transport
        (``shift_nbv``/``permute_nbv``): the request ships all m offsets
        in one message, the source slices every window, and the reply
        packs all m slices into one wire transfer — m gets for one
        initiation α per direction, instead of m.  Callers batching many
        fetches (e.g. KV page prefetch) pick the batch size with
        ``sched.plan_p2p`` on the total byte count.

        ``node.sync(h)`` returns the ``(m, size)`` stack.  ``pred`` gates
        the fetch SPMD-conditionally: a rank passing ``False`` runs the
        identical transfers but completes to zeros.
        """
        n = self.n_nodes
        inv = _inverse(frm, n)
        local = self.local(seg).reshape(-1)
        dev = self.my_id.device
        idxs = as_i32(indices, dev).reshape(-1)
        m = int(idxs.shape[0])
        if m == 0:
            raise ValueError("get_nbv needs at least one index")
        flag = _bool(pred, dev)
        # request leg: all m offsets travel to the source in one message
        (preq,) = self._move_nbv([idxs], frm)
        req = preq.wait()
        # source side: slice every window, pack into one reply payload
        data = torch.cat([dynamic_slice(local, req[j], size) for j in range(m)])
        # reply leg: one vectored transfer back to the requester
        (prep,) = self._move_nbv([data], inv)
        h = extended.GetvHandle(prep, m, size, flag)
        tr = obs_trace.active()
        if tr.enabled:
            h.span = tr.begin_async(
                "get_nbv", cat="rma",
                bytes=m * size * local.element_size(),
                m=m, engine=self.engine.name, seg=id(seg),
                pred=pred is not None,
            )
        self._outstanding.append(h)
        return h

    def get_v(
        self,
        seg: torch.Tensor,
        *,
        frm: Pattern = Shift(1),
        indices: torch.Tensor | Sequence[int],
        size: int = 1,
        pred: torch.Tensor | bool | None = None,
    ) -> torch.Tensor:
        """Blocking vectored get: ``get_nbv`` + immediate ``sync``."""
        return self.sync(
            self.get_nbv(seg, frm=frm, indices=indices, size=size, pred=pred)
        )

    def sync(self, handle: extended.Handle) -> torch.Tensor:
        """Complete one handle (``gasnet_wait_syncnb``): returns the
        updated segment for puts, the fetched data for gets.

        Several *outstanding* puts against the same segment object compose:
        each sync applies onto the result of the previous one (FIFO), so no
        write is lost (GASNet permits multiple puts in flight).  Once the
        last outstanding put on a segment completes the chain is dropped,
        so a later independent ``put``/``put_nb`` of the same array starts
        from its own snapshot again.
        """
        if handle in self._outstanding:
            self._outstanding.remove(handle)
        if isinstance(handle, extended.PutHandle):
            if handle.done:
                raise extended.AlreadyWaitedError(
                    f"{handle.op} handle already synced"
                )
            handle.done = True
            base = self._seg_latest.get(handle.key, handle._local)
            new_local = handle.apply(base)
            still_open = any(
                isinstance(h, extended.PutHandle) and h.key == handle.key
                for h in self._outstanding
            )
            if still_open:
                self._seg_latest[handle.key] = new_local
            else:
                self._seg_latest.pop(handle.key, None)
            result = handle.restore(new_local)
        else:
            result = handle.complete()
        sp = handle.span
        if sp is not None:
            handle.span = None
            obs_trace.active().end_async(sp)
        return result

    def defer(self, handle: extended.PutHandle):
        """Complete a put handle by handing its landing to the caller of
        ``Context.spmd``: returns the ``(payloads, offsets, flags)``
        command the receiver lands, for the program to return and the
        caller to write into the rank-stacked segment in place with
        :func:`repro_torch.core.extended.land` — for segments too large to
        copy per put.  Land deferred puts in the order they were issued.
        Puts on the same segment object must not mix ``sync`` and
        ``defer``."""
        if not isinstance(handle, extended.PutHandle):
            raise TypeError(f"only puts defer their landing, got {handle.op}")
        if handle.done:
            raise extended.AlreadyWaitedError(
                f"{handle.op} handle already synced")
        handle.done = True
        if handle in self._outstanding:
            self._outstanding.remove(handle)
        sp = handle.span
        if sp is not None:
            handle.span = None
            obs_trace.active().end_async(sp)
        return handle.landing()

    def try_sync(
        self, handle: extended.Handle
    ) -> Tuple[bool, Optional[torch.Tensor]]:
        """Poll one handle (``gasnet_try_syncnb``): ``(done, value)``.

        Under the static SPMD schedule every initiated transfer is
        guaranteed to complete, and the sync orders the streams on the
        device without the host waiting, so the poll always succeeds: it
        returns ``(True, value)`` as the reference does, the value
        completed through the transfer's event like :meth:`sync`.
        """
        return True, self.sync(handle)

    def sync_all(self) -> list:
        """Complete every outstanding handle in issue order
        (``gasnet_wait_syncnb_all``); returns their results FIFO.
        Outstanding puts on the same segment compose (see :meth:`sync`)."""
        results = []
        while self._outstanding:
            results.append(self.sync(self._outstanding[0]))
        return results

    # ----------------------------------------------------------------- #
    # Active Messages
    # ----------------------------------------------------------------- #
    def _ensure_batch(self) -> am_lib.AMBatch:
        if self._batch is None:
            self._batch = am_lib.empty_batch(
                self._am_capacity, self._am_payload_width,
                device=self.my_id.device,
            )
        return self._batch

    def am_short(
        self,
        dest: torch.Tensor,
        handler: str,
        args: Sequence[Any] = (),
        pred: torch.Tensor | bool | None = None,
    ):
        b = self._ensure_batch()
        self._batch = am_lib.push(
            b, dest, self.handlers.id_of(handler), args=args, pred=pred
        )

    def am_medium(
        self,
        dest: torch.Tensor,
        handler: str,
        payload: torch.Tensor,
        args: Sequence[Any] = (),
        pred: torch.Tensor | bool | None = None,
    ):
        b = self._ensure_batch()
        self._batch = am_lib.push(
            b, dest, self.handlers.id_of(handler), args=args, payload=payload,
            pred=pred,
        )

    def am_long(
        self,
        dest: torch.Tensor,
        handler: str,
        payload: torch.Tensor,
        dst_index: torch.Tensor | int,
        nelem: torch.Tensor | int = 0,
        pred: torch.Tensor | bool | None = None,
    ):
        """AMLong: payload lands at ``dst_index`` (flat) of the handler's
        segment; handler convention is ``long_write_handler``-compatible
        (args[0]=offset, args[1]=element count)."""
        b = self._ensure_batch()
        self._batch = am_lib.push(
            b,
            dest,
            self.handlers.id_of(handler),
            args=(dst_index, nelem),
            payload=payload,
            pred=pred,
        )

    def am_call(
        self,
        dest: torch.Tensor,
        handler: str,
        payload: torch.Tensor | None = None,
        args: Sequence[Any] = (),
        pred: torch.Tensor | bool | None = None,
        ack: Callable[[Any], Any] | None = None,
    ) -> Optional[extended.AckHandle]:
        """Queue a *request* to a ``replies=True`` handler (the GASNet
        AMRequest whose handler will send an AMReply back here).

        With ``ack`` (a pure ``state -> value`` fetch), returns an
        :class:`~repro_torch.core.extended.AckHandle` that the next
        :meth:`am_flush` resolves against the post-reply state —
        ``node.sync(h)`` then yields the acknowledgment value.
        """
        if not self.handlers.replies_of(handler):
            raise ValueError(
                f"am_call target {handler!r} is not a replying handler "
                "(register it with replies=True)"
            )
        if payload is None:
            self.am_short(dest, handler, args=args, pred=pred)
        else:
            self.am_medium(dest, handler, payload, args=args, pred=pred)
        if ack is None:
            return None
        h = extended.AckHandle(ack)
        self._pending_acks.append(h)
        self._outstanding.append(h)
        return h

    def am_flush(self, state: Any) -> Any:
        """Route all queued messages and run handlers at the receivers.
        Returns the updated receiver state.  (The poll loop of GASNet.)

        The router's all-to-all is plan-driven: ``repro_torch.core.sched``
        chooses native vs direct-put exchange from the buffer size and
        this node's engine cost model (heterogeneous maps route over
        their mixed puts).

        When the handler table contains ``replies=True`` handlers the
        flush is the full request/reply cycle — a second ``route`` hop
        carries each handler's ``AMReply`` back to its requester and runs
        the reply handlers — and any :class:`AckHandle` from
        :meth:`am_call` is resolved against the post-reply state."""
        batch = self._ensure_batch()
        kw = dict(
            axis=self.engine.axis,
            n_nodes=self.n_nodes,
            per_peer_capacity=self._am_per_peer,
            engine=self.engine,
        )
        with obs_trace.active().span(
            "am_flush", cat="am", engine=self.engine.name,
            replies=self.handlers.has_replies,
            capacity=self._am_per_peer,
        ):
            if self.handlers.has_replies:
                state, dropped = am_lib.request_reply(
                    state, batch, self.handlers, **kw
                )
            else:
                recv, dropped = am_lib.route(batch, **kw)
                state = am_lib.deliver(state, recv, self.handlers)
        self.dropped = self.dropped + dropped
        self._batch = None
        for h in self._pending_acks:
            h.resolve(state)
        self._pending_acks = []
        return state


def _bool(pred: Any, device) -> torch.Tensor:
    """True when ``pred`` is None, else ``pred`` as bool."""
    if pred is None:
        return torch.ones((), dtype=torch.bool, device=device)
    if isinstance(pred, torch.Tensor):
        return pred.to(torch.bool)
    return torch.full((), bool(pred), dtype=torch.bool, device=device)


class Context:
    """Session object: rank count + engine backend + handler table + device.

    ``backend`` is a single engine name (``"xla"`` — software nodes,
    ``"gascore"`` — hardware nodes), a comma-separated per-rank pattern
    (``"xla,gascore"`` — the paper's heterogeneous cluster: alternating
    software/hardware nodes in one job), or a sequence of per-rank names;
    see :func:`repro_torch.core.engine.make_engine`.  ``device`` defaults
    to CUDA; all ranks' partitions live on it.
    """

    def __init__(
        self,
        n_nodes: int,
        node_axis: str = "node",
        backend: str = "xla",
        device: Any = None,
        am_capacity: int = 16,
        am_payload_width: int = 8,
        am_per_peer_capacity: int | None = None,
    ):
        self.n_nodes = int(n_nodes)
        self.node_axis = node_axis
        self.backend = backend
        self.device = compat.resolve_device(device)
        self.handlers = am_lib.HandlerTable()
        self.am_capacity = am_capacity
        self.am_payload_width = am_payload_width
        self.am_per_peer_capacity = am_per_peer_capacity or am_capacity

    # ----------------------------------------------------------------- #
    def address_space(self) -> AddressSpace:
        return AddressSpace(self.n_nodes, self.device, self.node_axis)

    def register_handler(self, name: str, fn: Callable) -> int:
        return self.handlers.register(name, fn)

    def make_engine(self, ids: Optional[torch.Tensor] = None) -> CommEngine:
        return make_engine(self.backend, self.node_axis, self.n_nodes, ids)

    def make_node(self, ids: torch.Tensor) -> Node:
        return Node(
            self.make_engine(ids),
            self.handlers,
            self.am_capacity,
            self.am_payload_width,
            self.am_per_peer_capacity,
        )

    # ----------------------------------------------------------------- #
    def spmd(
        self,
        program: Callable,
        *args: Any,
        in_specs: Any = None,
        out_specs: Any = None,
    ) -> Any:
        """Run ``program(node, *local_args)`` as an SPMD node program.

        Default in/out specs treat every argument as a segment (split on
        the leading node axis).  Pass explicit specs — one per argument,
        and one per output (or one for all) — for replicated ``P()``
        arguments.  The program runs under ``torch.func.vmap`` over the
        ranks: an argument with ``P("node")`` of shape ``(n*a, ...)`` is
        seen by each rank as its ``(a, ...)`` slice, a ``P()`` argument
        whole; a ``P("node")`` output is concatenated over the ranks, a
        ``P()`` output is rank 0's.
        """
        n = self.n_nodes
        seg_spec = P(self.node_axis)
        if in_specs is None:
            in_specs = tuple(seg_spec for _ in args)
        elif isinstance(in_specs, P):
            in_specs = (in_specs,)
        if len(in_specs) != len(args):
            raise ValueError(f"{len(in_specs)} in_specs for {len(args)} args")
        if out_specs is None:
            out_specs = seg_spec

        def split(leaf: torch.Tensor) -> torch.Tensor:
            if leaf.shape[0] % n:
                raise ValueError(
                    f"leading dim {leaf.shape[0]} not divisible by {n} ranks"
                )
            return leaf.reshape((n, leaf.shape[0] // n) + tuple(leaf.shape[1:]))

        lifted = [
            compat.tree_map(split, a) if spec.sharded else a
            for a, spec in zip(args, in_specs)
        ]
        dims = tuple(0 if spec.sharded else None for spec in in_specs)

        def body(ids, *local_args):
            node = self.make_node(ids)
            return program(node, *local_args)

        ids = torch.arange(n, dtype=torch.int32, device=self.device)
        with cost.per_rank(n):  # an op-stream counter counts one rank
            out = vmap(body, in_dims=(0,) + dims, out_dims=0)(ids, *lifted)

        def join(spec, tree):
            if spec.sharded:
                return compat.tree_map(
                    lambda o: o.reshape((-1,) + tuple(o.shape[2:])), tree
                )
            return compat.tree_map(lambda o: o[0], tree)

        if isinstance(out_specs, P):
            return join(out_specs, out)
        return type(out)(join(s, o) for s, o in zip(out_specs, out))
