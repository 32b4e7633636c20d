"""GASNet Extended API: split-phase non-blocking one-sided operations.

The Core API's ``put``/``get`` are *blocking*: the call returns the fully
transferred value, so every subsequent statement is ordered after the wire.
Real GASNet applications (and the paper's GAScore clients) instead use the
Extended API — explicit-handle non-blocking ops — so the runtime can overlap
communication with independent compute.  This module reproduces that layer:

======================  ====================================================
GASNet Extended          here
======================  ====================================================
gasnet_put_nb            ``node.put_nb(seg, data, to=..., index=...)``
gasnet_get_nb            ``node.get_nb(seg, frm=..., index=..., size=...)``
gasnet_handle_t          :class:`PutHandle` / :class:`GetHandle`
gasnet_wait_syncnb       ``node.sync(handle)``
gasnet_try_syncnb        ``node.try_sync(handle)``
gasnet_wait_syncnb_all   ``node.sync_all()``
======================  ====================================================

Split-phase semantics in the port: *initiation* (``put_nb``/``get_nb``)
enqueues the transport on the current CUDA stream — the software engine's
indexing, or one launch of the GAScore copy kernel.  The *sync*
(``node.sync``) lands the data into its destination (segment update for
puts, reply value for gets).  Compute issued between the two has no data
dependence on the transfer; it is queued behind it on the same stream
(real overlap through a side stream and an event is later work).

Example (a matmul issued between a put's initiation and its sync)::

    def program(node, seg, w):
        h = node.put_nb(seg, node.local(seg)[:16], to=gasnet.Shift(1))
        acc = w @ w.T          # independent of the transfer
        seg = node.sync(h)     # split-phase completion
        return seg, acc

Handles are host-side Python objects (like the engines themselves) that
live for one ``Context.spmd`` call.  Completion order for ``sync_all`` is
FIFO (issue order), matching the deterministic static schedule.

Deferred landing: a put's sync inside the program is functional, so it
builds a new segment partition.  For a segment too large to copy per put
(a serving cluster's KV pool), ``node.defer(h)`` completes a put handle by
returning its *landing command* (payloads, target offsets, arrival
flags) as a program output instead; after ``Context.spmd`` returns,
:func:`land` writes the commands of all ranks into the rank-stacked
segment IN PLACE, with the same clamping and flag semantics as the sync
(the receiver's DMA engine finishing the write).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import transport
from repro_torch.core.engine import AlreadyWaitedError
from repro_torch.core.indexing import dynamic_update_slice

__all__ = [
    "land",
    "Handle",
    "PutHandle",
    "PutvHandle",
    "GetHandle",
    "GetvHandle",
    "AckHandle",
    "AlreadyWaitedError",
]


def _land(local: torch.Tensor, data: torch.Tensor, index: torch.Tensor,
          flag: torch.Tensor) -> torch.Tensor:
    """``local`` with ``data`` written at flat ``index`` where ``flag`` is
    set; where it is clear every byte keeps its bits.  JAX's slice + select
    + update, as one select."""
    flat = local.reshape(-1)
    new = dynamic_update_slice(flat, data, index)
    return torch.where(flag, new, flat).reshape(local.shape)


def land(seg: torch.Tensor, payload: torch.Tensor, offsets: torch.Tensor,
         flags: torch.Tensor, chunk: int = 1 << 22) -> torch.Tensor:
    """Land deferred put commands in place: for every rank r and command
    j in order, ``payload[r, j]`` (L elements) is written at flat offset
    ``offsets[r, j]`` (clamped to ``[0, S - L]``, as ``sync`` clamps) of
    rank r's partition of the rank-stacked ``seg`` (n, *local) where
    ``flags[r, j]`` is set; elsewhere every byte keeps its bits.  No
    offset or flag is read on the host, and the segment is never copied:
    its storage is written where it lies.  Returns ``seg``."""
    n = seg.shape[0]
    flat = seg.view(n, -1)
    S = flat.shape[1]
    m, L = int(payload.shape[1]), int(payload.shape[2])
    start = offsets.reshape(n, m).to(torch.int64).clamp(0, max(S - L, 0))
    flags = flags.reshape(n, m).to(torch.bool)
    for j in range(m):
        for c0 in range(0, L, chunk):
            c = min(chunk, L - c0)
            pos = start[:, j, None] + torch.arange(
                c0, c0 + c, device=flat.device)
            cur = flat.gather(1, pos)
            new = payload[:, j, c0 : c0 + c].to(flat.dtype)
            flat.scatter_(1, pos, torch.where(flags[:, j, None], new, cur))
    return seg


class Handle:
    """Base explicit handle (``gasnet_handle_t``) of one non-blocking op.

    Subclasses carry the in-flight values captured at initiation; the
    owning :class:`~repro_torch.core.gasnet.Node` completes them via
    ``node.sync(handle)``.
    """

    op: str = "nop"
    # open trace span riding the handle from initiation to sync (set by
    # the Node when tracing is enabled; None otherwise)
    span = None

    def __init__(self) -> None:
        self.done = False

    def _complete(self) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    def complete(self) -> Any:
        """Finish the op (idempotent error: a handle syncs exactly once).

        Raises :class:`AlreadyWaitedError` naming the op, so batch waits
        (``node.sync_all``) over a list containing an already-synced
        handle fail with a debuggable message."""
        if self.done:
            raise AlreadyWaitedError(f"{self.op} handle already synced")
        self.done = True
        return self._complete()


class PutHandle(Handle):
    """In-flight ``put_nb``: the payload, target offset and arrival flag
    have been shipped (transport initiated); :meth:`complete` lands them in
    the receiver's partition of the segment and returns the updated
    segment.

    ``key`` identifies the segment object the put was issued against, so
    the owning Node can chain several outstanding puts on the same segment
    (each sync applies onto the latest synced version, not the stale
    snapshot taken at initiation — GASNet permits multiple outstanding
    puts)."""

    op = "put"

    def __init__(
        self,
        local: torch.Tensor,
        moved: torch.Tensor,
        midx: torch.Tensor,
        received: torch.Tensor,
        restore,
        key: int = 0,
    ):
        super().__init__()
        self._local = local
        self._moved = moved
        self._midx = midx
        self._received = received
        self._restore = restore
        self.key = key

    def apply(self, local: torch.Tensor) -> torch.Tensor:
        """Land the in-flight data into ``local`` (a segment partition of
        the same shape as the one snapshotted at initiation)."""
        return _land(local, self._moved, self._midx, self._received)

    def restore(self, local: torch.Tensor) -> torch.Tensor:
        return self._restore(local)

    def landing(self):
        """The receiver's landing command: ``(payloads (m, L), offsets
        (m,), flags (m,))`` with m = 1 (see :func:`land`)."""
        return self._moved[None], self._midx.reshape(1), self._received.reshape(1)

    def _complete(self) -> torch.Tensor:
        return self._restore(self.apply(self._local))


class PutvHandle(PutHandle):
    """In-flight vectored ``put_nbv`` (engine multi-put): m payloads plus
    the int32 *command block* (their m target offsets + m arrival flags)
    travelled as one vectored transport — the write half of the GAScore
    draining a command FIFO in a single wire message.  :meth:`complete`
    waits the payload/meta :class:`~repro_torch.core.engine.Pending`\\ s and
    lands every flagged payload at its offset in the receiver's partition.

    Per-payload flags make the put SPMD-conditional at page granularity: a
    sender clearing flag j ships payload j anyway (the static schedule)
    but the receiver keeps its current bytes at offset j.  Chains with
    other outstanding puts on the same segment via the inherited ``key``
    (see ``Node.sync``)."""

    op = "putv"

    def __init__(self, local, payloads, meta, restore, key: int = 0):
        Handle.__init__(self)
        self._local = local
        self._payloads = payloads  # list[Pending | torch.Tensor]
        self._meta = meta  # Pending | torch.Tensor; int32 or bitcast carrier
        self._restore = restore
        self.key = key
        self._landed = None

    def _land(self):
        if self._landed is None:
            vals = [
                p.wait() if hasattr(p, "wait") else p for p in self._payloads
            ]
            m = (
                self._meta.wait()
                if hasattr(self._meta, "wait")
                else self._meta
            )
            if m.dtype != torch.int32:
                m = transport.bitcast(m, torch.int32)  # back from the carrier
            n = len(vals)
            self._landed = (vals, m[:n], m[n:] != 0)
        return self._landed

    def apply(self, local: torch.Tensor) -> torch.Tensor:
        vals, offs, flags = self._land()
        for j, v in enumerate(vals):
            local = _land(local, v, offs[j], flags[j])
        return local

    def landing(self):
        vals, offs, flags = self._land()
        return torch.stack(vals), offs, flags


class GetHandle(Handle):
    """In-flight ``get_nb``: the request (offset) has travelled to the
    source and the reply is on the wire; :meth:`complete` returns the
    fetched data."""

    op = "get"

    def __init__(self, reply: torch.Tensor):
        super().__init__()
        self._reply = reply

    def _complete(self) -> torch.Tensor:
        return self._reply


class GetvHandle(Handle):
    """In-flight vectored ``get_nbv`` (engine multi-get): the request leg
    shipped every offset in one vectored transport and the reply leg —
    all fetched slices packed into one wire message — is in flight;
    :meth:`complete` waits the reply :class:`~repro_torch.core.engine.Pending`
    and returns the ``(m, size)`` stack of fetched vectors.

    ``pred`` gates the fetch SPMD-conditionally: every rank runs both
    legs (the static schedule), but a rank that initiated with
    ``pred=False`` completes to zeros — the vector analogue of the
    cleared arrival flag of a pred-gated put."""

    op = "getv"

    def __init__(self, reply, m: int, size: int, pred: torch.Tensor):
        super().__init__()
        self._reply = reply  # Pending | torch.Tensor
        self._m = m
        self._size = size
        self._pred = pred

    def _complete(self) -> torch.Tensor:
        data = (
            self._reply.wait()
            if hasattr(self._reply, "wait")
            else self._reply
        )
        out = data.reshape(self._m, self._size)
        return torch.where(self._pred, out, torch.zeros_like(out))


class AckHandle(Handle):
    """A pending remote acknowledgment (the handle half of an AM
    request/reply round trip — ``Node.am_call``).

    At initiation the request is only *queued*; the acknowledgment value
    does not exist until ``node.am_flush`` has routed the request, run the
    remote handler, and routed its ``AMReply`` back.  The flush resolves
    the handle by applying ``fetch`` to the post-reply handler state;
    ``node.sync(handle)`` then returns that value.  Syncing before the
    flush is an ordering error and raises."""

    op = "ack"

    def __init__(self, fetch: Callable[[Any], Any]):
        super().__init__()
        self._fetch = fetch
        self._value: Any = None
        self._resolved = False

    @property
    def resolved(self) -> bool:
        return self._resolved

    def resolve(self, state: Any) -> None:
        self._value = self._fetch(state)
        self._resolved = True

    def _complete(self) -> Any:
        if not self._resolved:
            raise RuntimeError(
                "ack handle synced before am_flush delivered the reply"
            )
        return self._value
