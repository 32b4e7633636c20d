"""Active Messages (GASNet Core API), in bulk-synchronous SPMD form.

A GASNet *Active Message* is a packet carrying a data payload, a destination
node, and the ID of a *handler function* that runs at the receiver when the
packet lands.  The paper's GAScore engine generates and consumes exactly
these packets in hardware.

The port keeps the reference's (``repro.core.am``) bulk-synchronous form of
handler-on-arrival semantics:

1. every node accumulates outgoing messages into a fixed-capacity
   :class:`AMBatch` (the "FIFO command queue" in front of the GAScore);
2. :func:`route` moves all batches simultaneously with a capacity-bounded
   all-to-all (the on-chip packet network) — a *static* SPMD schedule;
3. :func:`deliver` runs the registered handler of each landed message
   against the receiver's local state (the asynchronous handler call,
   now a fused receiver-side epilogue).

Message categories follow GASNet:

- **AMShort**  — handler args only, no payload.
- **AMMedium** — payload delivered to a bounded temporary buffer, handler
  decides placement.
- **AMLong**   — payload written at a caller-specified segment offset
  (``args[0]``); the built-in :func:`long_write_handler` reproduces the
  GAScore remote-DMA write.

**Request/reply** (GASNet Core rule: every AM is a *request* whose handler
may issue exactly one *reply* back to the requester, and reply handlers may
not reply again).  A handler registered with ``replies=True`` returns
``(state, AMReply)``; :func:`deliver_with_replies` collects the replies of
all landed requests into a second :class:`AMBatch` addressed at the sender
tokens, and :func:`request_reply` routes that batch in a second
:func:`route` hop and delivers it — the two-hop schedule is static, so the
whole round trip runs under ``Context.spmd``'s vmap over the ranks.  Build replies with
:func:`reply_short` / :func:`reply_medium` (or :func:`no_reply` to decline).

Everything here is pure-functional and shape-static, so it runs per rank
under ``torch.func.vmap``.  Where the reference takes a ``lax.cond``,
``lax.switch`` or ``lax.scan`` over a rank-dependent value, the port
evaluates every branch and selects (as vmap over the reference would):
delivery loops over the static capacity in Python and runs every handler
on every slot, so handlers must stay pure.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

import torch

from repro_torch import compat
from repro_torch.core.indexing import as_i32, dynamic_slice, dynamic_update_slice
from repro_torch.obs import trace as obs_trace

__all__ = [
    "AMBatch",
    "AMReply",
    "HandlerTable",
    "empty_batch",
    "push",
    "build_send_buffer",
    "route",
    "deliver",
    "deliver_with_replies",
    "request_reply",
    "no_reply",
    "reply_short",
    "reply_medium",
    "long_write_handler",
]

MAX_ARGS = 4  # GASNet Core allows up to 16 handler args; 4 suffice here.


# --------------------------------------------------------------------------- #
# Handler registry
# --------------------------------------------------------------------------- #
class HandlerTable:
    """Ordered registry name -> (id, fn).

    Handler signature: ``fn(state, payload, args) -> state`` where ``state``
    is a tree of tensors (typically the node's local segment views),
    ``payload`` is a flat ``(payload_size,)`` vector and ``args`` a
    ``(MAX_ARGS,)`` int32 vector.  Handlers must be pure and return a tree
    of identical structure (every handler runs on every slot, and the
    results are selected by handler id).

    A handler registered with ``replies=True`` is a GASNet *request*
    handler: it returns ``(state, AMReply)`` and its reply is routed back
    to the requester by :func:`request_reply`.  Reply handlers themselves
    must be plain (``replies=False``) — GASNet forbids replying to a reply,
    and :func:`request_reply` enforces this by discarding nested replies.
    """

    def __init__(self) -> None:
        self._names: List[str] = []
        self._fns: List[Callable] = []
        self._replies: List[bool] = []

    def register(self, name: str, fn: Callable, replies: bool = False) -> int:
        if name in self._names:
            raise ValueError(f"handler {name!r} already registered")
        self._names.append(name)
        self._fns.append(fn)
        self._replies.append(bool(replies))
        return len(self._names) - 1

    def handler(self, name: str, replies: bool = False) -> Callable:
        """Decorator form of :meth:`register`."""

        def deco(fn: Callable) -> Callable:
            self.register(name, fn, replies=replies)
            return fn

        return deco

    def id_of(self, name: str) -> int:
        return self._names.index(name)

    def replies_of(self, name: str) -> bool:
        return self._replies[self.id_of(name)]

    @property
    def fns(self) -> Tuple[Callable, ...]:
        return tuple(self._fns)

    @property
    def reply_flags(self) -> Tuple[bool, ...]:
        return tuple(self._replies)

    @property
    def has_replies(self) -> bool:
        return any(self._replies)

    def __len__(self) -> int:
        return len(self._names)


# --------------------------------------------------------------------------- #
# Message batches
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class AMBatch:
    """Fixed-capacity outgoing message queue of ONE node (local view).

    Attributes (capacity C, payload width Pw):
      dest:    (C,)  int32   destination node id per slot.
      handler: (C,)  int32   handler id per slot.
      args:    (C, MAX_ARGS) int32 handler arguments.
      payload: (C, Pw) payload rows (zero width for AMShort-only batches).
      valid:   (C,)  bool    slot occupancy.
      count:   ()    int32   number of occupied slots.
    """

    dest: torch.Tensor
    handler: torch.Tensor
    args: torch.Tensor
    payload: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.dest.shape[0]

    @property
    def payload_width(self) -> int:
        return self.payload.shape[1]


@dataclasses.dataclass
class AMReply:
    """Shape-static reply descriptor returned by a request handler.

    Attributes (payload width Pw of the delivering batch):
      send:    ()  bool    whether a reply is actually issued.
      handler: ()  int32   reply handler id (must be ``replies=False``).
      args:    (MAX_ARGS,) int32 reply handler arguments (AMReplyShort).
      payload: (Pw,)       reply payload (AMReplyMedium; zeros for Short).
    """

    send: torch.Tensor
    handler: torch.Tensor
    args: torch.Tensor
    payload: torch.Tensor


def _arg_vec(args: Sequence[Any], device=None) -> torch.Tensor:
    vals = [as_i32(a, device).reshape(()) for a in args]
    pad = [torch.zeros((), dtype=torch.int32, device=device)] * (
        MAX_ARGS - len(vals))
    return torch.stack(vals + pad) if vals else torch.zeros(
        (MAX_ARGS,), dtype=torch.int32, device=device)


def no_reply(payload_width: int, dtype: Any = torch.float32,
             device=None) -> AMReply:
    """The declined reply (the request handler stays one-way)."""
    return AMReply(
        send=torch.zeros((), dtype=torch.bool, device=device),
        handler=torch.zeros((), dtype=torch.int32, device=device),
        args=torch.zeros((MAX_ARGS,), dtype=torch.int32, device=device),
        payload=torch.zeros((payload_width,), dtype=dtype, device=device),
    )


def reply_short(
    handler: int, args: Sequence[Any] = (), *, like: torch.Tensor
) -> AMReply:
    """AMReplyShort: handler id + args, no payload.  ``like`` is the request
    payload (or any ``(Pw,)`` vector of the batch dtype) fixing the reply
    payload shape — all handlers must agree on it."""
    return AMReply(
        send=torch.ones((), dtype=torch.bool, device=like.device),
        handler=as_i32(handler, like.device),
        args=_arg_vec(args, like.device),
        payload=torch.zeros_like(like),
    )


def reply_medium(
    handler: int, payload: torch.Tensor, args: Sequence[Any] = ()
) -> AMReply:
    """AMReplyMedium: payload travels back to the requester."""
    return AMReply(
        send=torch.ones((), dtype=torch.bool, device=payload.device),
        handler=as_i32(handler, payload.device),
        args=_arg_vec(args, payload.device),
        payload=payload,
    )


def empty_batch(capacity: int, payload_width: int,
                dtype: Any = torch.float32, device=None) -> AMBatch:
    return AMBatch(
        dest=torch.zeros((capacity,), dtype=torch.int32, device=device),
        handler=torch.zeros((capacity,), dtype=torch.int32, device=device),
        args=torch.zeros((capacity, MAX_ARGS), dtype=torch.int32,
                         device=device),
        payload=torch.zeros((capacity, payload_width), dtype=dtype,
                            device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def push(
    batch: AMBatch,
    dest: torch.Tensor,
    handler: int,
    args: Sequence[Any] = (),
    payload: torch.Tensor | None = None,
    pred: torch.Tensor | bool | None = None,
) -> AMBatch:
    """Enqueue one message (functional).  Overflow beyond capacity is dropped
    silently here and surfaced by :func:`build_send_buffer` as a count —
    matching GASNet back-pressure semantics in a shape-static world.

    ``pred`` gates the enqueue (shape-static conditional send): under SPMD
    every rank runs the same ``push``, and a rank with nothing to say
    passes ``pred=False`` — the slot is simply not occupied."""
    device = batch.dest.device
    C = batch.capacity
    i = torch.clamp(batch.count, max=C - 1)
    in_range = batch.count < C
    if pred is not None:
        in_range = in_range & torch.as_tensor(pred, device=device).to(
            torch.bool)
    arg_vec = _arg_vec(args, device)
    if payload is None:
        payload = torch.zeros((batch.payload_width,),
                              dtype=batch.payload.dtype, device=device)
    payload = payload.to(batch.payload.dtype).reshape(-1)
    if payload.shape[0] != batch.payload_width:
        raise ValueError(
            f"payload width {payload.shape[0]} != batch width "
            f"{batch.payload_width}"
        )
    # ``lax.cond(in_range, write, identity)`` as one select per field
    hit = (torch.arange(C, device=device) == i) & in_range
    col = hit[:, None]
    return AMBatch(
        dest=torch.where(hit, as_i32(dest, device), batch.dest),
        handler=torch.where(hit, as_i32(handler, device), batch.handler),
        args=torch.where(col, arg_vec[None, :], batch.args),
        payload=torch.where(col, payload[None, :], batch.payload),
        valid=batch.valid | hit,
        count=batch.count + in_range.to(torch.int32),
    )


# --------------------------------------------------------------------------- #
# Routing (the on-chip packet network)
# --------------------------------------------------------------------------- #
def build_send_buffer(
    batch: AMBatch, n_nodes: int, per_peer_capacity: int
) -> Tuple[AMBatch, torch.Tensor]:
    """Pack a node's outgoing queue into a dense (n_nodes * K)-slot buffer,
    slot ``d*K + r`` holding the r-th message addressed to node d.

    Returns the packed batch (capacity n_nodes*K, same widths) plus the
    number of messages dropped because more than K were addressed to one
    peer (the static-capacity analogue of network back-pressure).
    """
    K = per_peer_capacity
    device = batch.dest.device
    parked = torch.full_like(batch.dest, n_nodes)
    dest = torch.where(batch.valid, batch.dest, parked)  # park invalid
    # rank of each message within its destination group (stable order)
    one_hot = (dest[:, None] == torch.arange(n_nodes + 1, device=device)[None, :]
               ).to(torch.int32)
    rank = torch.cumsum(one_hot, dim=0, dtype=torch.int32) - one_hot
    rank = torch.gather(rank, 1, dest[:, None].long())[:, 0]
    ok = batch.valid & (rank < K) & (dest < n_nodes)
    C = n_nodes * K
    slot = torch.where(ok, dest * K + rank, torch.full_like(dest, C))
    dropped = torch.sum(batch.valid & ~ok).to(torch.int32)

    # scatter each message into its slot (``.at[slot].set``): every slot
    # below C holds at most one message, so a gather by the matching
    # message is the same scatter, and it runs under vmap
    match = slot[None, :] == torch.arange(C, device=device)[:, None]  # (C, cap)
    has = match.any(dim=1)
    src = torch.argmax(match.to(torch.int32), dim=1)

    def scatter(x: torch.Tensor, fill: Any) -> torch.Tensor:
        got = x.index_select(0, src)
        filler = torch.full_like(got, fill)
        h = has.reshape((C,) + (1,) * (x.dim() - 1))
        return torch.where(h, got, filler)

    packed = AMBatch(
        dest=scatter(batch.dest, 0),
        handler=scatter(batch.handler, 0),
        args=scatter(batch.args, 0),
        payload=scatter(batch.payload, 0),
        valid=scatter(ok, False),
        count=torch.sum(ok).to(torch.int32),
    )
    return packed, dropped


def route(
    batch: AMBatch,
    *,
    axis: str,
    n_nodes: int,
    per_peer_capacity: int,
    all_to_all_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    engine=None,
) -> Tuple[AMBatch, torch.Tensor]:
    """Exchange all nodes' batches; returns each node's *incoming* messages.

    Must be called inside ``Context.spmd``.  The transport is ``engine``
    (a CommEngine — the exchange is then *plan-driven*:
    ``repro_torch.core.sched`` picks native vs direct-put all-to-all from
    the buffer size and the engine's cost model, so a GAScore or mixed node
    map routes AMs over its own puts), else ``all_to_all_fn`` (an explicit
    callable).  ``axis`` names the rank axis, as in the reference.

    The incoming batch has capacity ``n_nodes * K``; slot ``s*K + r`` holds
    the r-th message from source node s.  ``dest`` of received messages is
    rewritten to the *source* node id (GASNet handlers receive the sender's
    identity as the ``token``).
    """
    K = per_peer_capacity
    if engine is None and all_to_all_fn is None:
        raise ValueError("route needs an engine or an all_to_all_fn")
    tr = obs_trace.active()
    if tr.enabled:
        w = batch.payload_width
        tr.instant(
            "am_route", cat="am", n_nodes=n_nodes, capacity=K,
            payload_width=w,
            engine=getattr(engine, "name", None) if engine is not None
            else "custom",
        )
    packed, dropped = build_send_buffer(batch, n_nodes, K)

    def exchange(x: torch.Tensor) -> torch.Tensor:
        # (n_nodes*K, ...) -> regroup so dim0 blocks are per-destination
        if engine is not None:
            from repro_torch.core import sched

            return sched.all_to_all(engine, x)
        return all_to_all_fn(x)

    exchange(packed.dest)  # moved as the reference moves it, then replaced
    recv_handler = exchange(packed.handler)
    recv_args = exchange(packed.args)
    recv_payload = exchange(packed.payload)
    recv_valid = exchange(packed.valid)
    # annotate source node per received slot
    src = torch.repeat_interleave(
        torch.arange(n_nodes, dtype=torch.int32, device=recv_valid.device), K
    )
    recv = AMBatch(
        dest=src,  # now: sender token
        handler=recv_handler,
        args=recv_args,
        payload=recv_payload,
        valid=recv_valid,
        count=torch.sum(recv_valid).to(torch.int32),
    )
    return recv, dropped


# --------------------------------------------------------------------------- #
# Delivery (asynchronous handler invocation, fused)
# --------------------------------------------------------------------------- #
def deliver_with_replies(
    state: Any, recv: AMBatch, handlers: HandlerTable
) -> Tuple[Any, AMBatch]:
    """Apply each landed message's handler to the local state, in slot order,
    and collect the replies of ``replies=True`` handlers.

    Exactly-once: every valid slot fires its handler exactly once; invalid
    slots leave the state as it was.  The reference scans over the slots
    with a ``lax.switch`` over handler ids; the port loops over the static
    capacity and, per slot, runs every handler and selects the one named by
    the (clipped) id — sequential like the paper's handler queue.

    Returns ``(state, reply_batch)``: slot s of the reply batch is the
    reply (if any) of the request in slot s of ``recv``, addressed at that
    request's sender token — ready for a second :func:`route` hop.
    """
    fns = handlers.fns
    flags = handlers.reply_flags
    if not fns:
        raise ValueError("no handlers registered")
    pw = recv.payload_width
    pdtype = recv.payload.dtype
    device = recv.payload.device
    declined = no_reply(pw, pdtype, device)
    reps: List[AMReply] = []
    for s in range(recv.capacity):
        valid, hid = recv.valid[s], recv.handler[s]
        args, payload = recv.args[s], recv.payload[s]
        hid = torch.clamp(hid, 0, len(fns) - 1)
        st, rep = state, declined
        for h, (f, replies) in enumerate(zip(fns, flags)):
            if replies:
                st_h, rep_h = f(state, payload, args)
            else:
                st_h, rep_h = f(state, payload, args), declined
            fire = valid & (hid == h)
            st = compat.tree_map(lambda a, b: torch.where(fire, a, b), st_h, st)
            rep = AMReply(*(
                torch.where(fire, a, b) for a, b in zip(
                    (rep_h.send, rep_h.handler, rep_h.args, rep_h.payload),
                    (rep.send, rep.handler, rep.args, rep.payload))
            ))
        state = st
        reps.append(rep)
    valid = recv.valid & torch.stack([r.send for r in reps])
    reply = AMBatch(
        dest=recv.dest,  # the sender token of each request
        handler=torch.stack([r.handler for r in reps]),
        args=torch.stack([r.args for r in reps]),
        payload=torch.stack([r.payload for r in reps]),
        valid=valid,
        count=torch.sum(valid).to(torch.int32),
    )
    return state, reply


def deliver(state: Any, recv: AMBatch, handlers: HandlerTable) -> Any:
    """One-way delivery (see :func:`deliver_with_replies`); replies of any
    ``replies=True`` handlers are discarded — this is the reply-hop rule
    (a reply handler may not reply again)."""
    state, _ = deliver_with_replies(state, recv, handlers)
    return state


def request_reply(
    state: Any,
    batch: AMBatch,
    handlers: HandlerTable,
    *,
    axis: str,
    n_nodes: int,
    per_peer_capacity: int,
    all_to_all_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    engine=None,
) -> Tuple[Any, torch.Tensor]:
    """The full GASNet request/reply cycle, statically scheduled:

    1. :func:`route` the request batch (hop 1) and deliver it, collecting
       the ``AMReply`` each request handler returns;
    2. :func:`route` the reply batch back (hop 2) and deliver it one-way
       (nested replies are discarded — GASNet's no-reply-to-a-reply rule).

    The reply hop reuses the same per-peer capacity: a node holds at most
    ``per_peer_capacity`` requests per source, hence at most that many
    replies per destination, so hop 2 can never drop for capacity.
    Returns ``(state, dropped)`` with the hop-1 + hop-2 drop count.
    """
    tr = obs_trace.active()
    with tr.span("am_request_hop", cat="am", n_nodes=n_nodes):
        recv, dropped = route(
            batch, axis=axis, n_nodes=n_nodes,
            per_peer_capacity=per_peer_capacity,
            all_to_all_fn=all_to_all_fn, engine=engine,
        )
        state, replies = deliver_with_replies(state, recv, handlers)
    with tr.span("am_reply_hop", cat="am", n_nodes=n_nodes):
        recv2, dropped2 = route(
            replies, axis=axis, n_nodes=n_nodes,
            per_peer_capacity=per_peer_capacity,
            all_to_all_fn=all_to_all_fn, engine=engine,
        )
        state = deliver(state, recv2, handlers)
    return state, dropped + dropped2


def long_write_handler(seg_key: str) -> Callable:
    """Built-in AMLong handler: GAScore-style remote write of the payload at
    flat offset ``args[0]`` (element count ``args[1]``, 0 = whole payload)
    into ``state[seg_key]`` (any-shaped local segment view)."""

    def fn(state: Any, payload: torch.Tensor, args: torch.Tensor) -> Any:
        seg = state[seg_key]
        flat = seg.reshape(-1)
        width = payload.shape[0]
        nelem = torch.where(args[1] > 0, args[1], width)
        off = args[0]
        cur = dynamic_slice(flat, off, width)
        mask = torch.arange(width, device=flat.device) < nelem
        new = torch.where(mask, payload.to(flat.dtype), cur)
        flat = dynamic_update_slice(flat, new, off)
        out = dict(state)
        out[seg_key] = flat.reshape(seg.shape)
        return out

    return fn
