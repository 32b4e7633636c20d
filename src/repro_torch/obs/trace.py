"""Per-rank span/event tracing clocked on the SPMD tick counter.

GASNet's split-phase operations are invisible between initiation and
sync — ``GASNET_TRACE`` exists because a hung ``gasnet_put_nb`` tells
you nothing about *which* transfer, to where, how big.  This tracer is
the software analogue, with two hard constraints from running under
JAX:

- **Compiled-code-safe.**  Spans are recorded on the *host*, around
  initiation (``put_nb`` returning a handle) and sync (``sync`` /
  ``sync_all``) — never inside traced/compiled code.  Handles are
  trace-time Python objects, so a split-phase span simply rides the
  handle from initiation to sync.
- **Zero-cost when disabled.**  ``active()`` returns a module-level
  no-op recorder unless tracing was enabled; every instrumentation
  site in the hot path guards on one attribute check
  (``tr = trace.active(); if tr.enabled: ...``).

Timestamps are dual: the **tick clock** (``set_tick`` + a per-tick
sequence number) is deterministic and is what the export merges ranks
on; the wall clock (``perf_counter``) rides along in every event for
real durations (e.g. ``EngineCost.fit_from_trace``).  Span ids are a
plain counter — deterministic across replays of the same schedule.

Events live in a bounded ring (``collections.deque``), which is what
makes the flight recorder free: the last-N-ticks dump on rank death is
just a filter over the ring.

With ``Tracer(annotate=cats)`` every scoped span of the categories
``cats`` is also a ``torch.profiler.record_function`` range named
``"<cat>::<name>"``, so a ``torch.profiler`` session attributes the
device's kernels to the spans that issued them (a range appears on the
device's timeline spanning its kernels).  Pick categories whose spans do
not nest: the profiler gives a kernel to its innermost range only.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Collection, Dict, Iterator, List, Optional

import torch

from repro_torch.obs.metrics import Registry

__all__ = [
    "NullTracer",
    "Span",
    "Tracer",
    "active",
    "disable",
    "enable",
]


class Span:
    """One recorded event: a closed span, an async (split-phase) span,
    or an instant.  ``tick0/seq0`` is the tick-clock position of the
    begin, ``tick1/seq1`` of the end (equal for instants); ``t0_us`` /
    ``t1_us`` are wall-clock microseconds since the tracer's epoch."""

    __slots__ = (
        "sid", "name", "cat", "kind", "rank",
        "tick0", "seq0", "tick1", "seq1", "t0_us", "t1_us", "args",
        "annotation",
    )

    def __init__(self, sid, name, cat, kind, rank,
                 tick0, seq0, t0_us, args):
        self.sid = sid
        self.name = name
        self.cat = cat
        self.kind = kind  # "span" | "async" | "instant"
        self.rank = rank
        self.tick0 = tick0
        self.seq0 = seq0
        self.tick1 = tick0
        self.seq1 = seq0
        self.t0_us = t0_us
        self.t1_us = t0_us
        self.args = args
        self.annotation = None  # open profiler range (annotating tracer)

    @property
    def dur_us(self) -> float:
        """Wall-clock duration (microseconds)."""
        return self.t1_us - self.t0_us

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Span({self.name!r}, cat={self.cat!r}, kind={self.kind!r}, "
            f"rank={self.rank}, tick={self.tick0}->{self.tick1}, "
            f"args={self.args})"
        )


class _NoopCtx:
    """Reusable no-op context manager (``NullTracer.span``)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP_CTX = _NoopCtx()


class NullTracer:
    """The disabled recorder: every method is a no-op, ``enabled`` is
    False.  Instrumentation sites check ``enabled`` once and skip; the
    per-tick sites that use ``span(...)`` contexts get a shared no-op
    context object."""

    enabled = False
    __slots__ = ()

    def set_tick(self, tick: int) -> None:
        pass

    def set_rank(self, rank: Optional[int]) -> None:
        pass

    def begin(self, name, cat="span", rank=None, **args):
        return None

    def end(self, span, **args) -> None:
        pass

    def begin_async(self, name, cat="span", rank=None, **args):
        return None

    def end_async(self, span, **args) -> None:
        pass

    def instant(self, name, cat="event", rank=None, **args) -> None:
        pass

    def span(self, name, cat="span", rank=None, **args):
        return _NOOP_CTX


class _SpanCtx:
    """Context manager pairing ``begin``/``end`` for scoped spans."""

    __slots__ = ("_tr", "_span")

    def __init__(self, tr: "Tracer", span: Span):
        self._tr = tr
        self._span = span

    def __enter__(self) -> Span:
        return self._span

    def __exit__(self, *exc) -> bool:
        self._tr.end(self._span)
        return False


class Tracer:
    """Recording tracer.  See module docstring for the clock model."""

    enabled = True

    def __init__(self, capacity: int = 65536,
                 registry: Optional[Registry] = None,
                 annotate: Collection[str] = ()):
        self.capacity = capacity
        self.annotate = frozenset(annotate)
        self.registry = registry if registry is not None else Registry()
        self.events: deque = deque(maxlen=capacity)
        self.tick = 0
        self.rank: Optional[int] = None
        self._sid = 0
        self._seq = 0
        self._epoch_ns = time.perf_counter_ns()

    # ---------------------------------------------------------------- #
    # clocks
    # ---------------------------------------------------------------- #
    def set_tick(self, tick: int) -> None:
        """Advance the deterministic tick clock (the disagg cluster calls
        this once per ``tick()``); the per-tick sequence counter resets."""
        self.tick = tick
        self._seq = 0

    def set_rank(self, rank: Optional[int]) -> None:
        """Default rank attributed to events that don't pass ``rank=``.
        ``None`` means the program-wide (collective/transport) row."""
        self.rank = rank

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._epoch_ns) / 1e3

    def _stamp(self) -> tuple:
        seq = self._seq
        self._seq = seq + 1
        return self.tick, seq, self._now_us()

    # ---------------------------------------------------------------- #
    # recording
    # ---------------------------------------------------------------- #
    def _open(self, name, cat, kind, rank, args) -> Span:
        sid = self._sid
        self._sid = sid + 1
        tick, seq, t_us = self._stamp()
        return Span(sid, name, cat, kind,
                    self.rank if rank is None else rank,
                    tick, seq, t_us, args)

    def begin(self, name: str, cat: str = "span",
              rank: Optional[int] = None, **args) -> Span:
        """Open a scoped span (must ``end`` before its parent ends —
        use :meth:`span` for the with-statement form)."""
        span = self._open(name, cat, "span", rank, args)
        if cat in self.annotate:
            span.annotation = torch.profiler.record_function(f"{cat}::{name}")
            span.annotation.__enter__()
        return span

    def end(self, span: Span, **args) -> None:
        if args:
            span.args.update(args)
        span.tick1, span.seq1, span.t1_us = self._stamp()
        self.events.append(span)
        if span.annotation is not None:
            span.annotation.__exit__(None, None, None)
            span.annotation = None

    def begin_async(self, name: str, cat: str = "span",
                    rank: Optional[int] = None, **args) -> Span:
        """Open a split-phase span: initiation now, sync later, possibly
        ticks later, with other spans opening and closing in between."""
        return self._open(name, cat, "async", rank, args)

    def end_async(self, span: Span, **args) -> None:
        if args:
            span.args.update(args)
        span.tick1, span.seq1, span.t1_us = self._stamp()
        self.events.append(span)
        # RMA byte accounting: the per-op byte counters the export's
        # validation compares against span byte totals, bit-for-bit.
        if span.cat == "rma":
            b = span.args.get("bytes")
            if b is not None:
                reg = self.registry
                reg.counter(f"rma_{span.name}_bytes").inc(int(b))
                reg.counter(f"rma_{span.name}_ops").inc()

    def instant(self, name: str, cat: str = "event",
                rank: Optional[int] = None, **args) -> Span:
        sp = self._open(name, cat, "instant", rank, args)
        self.events.append(sp)
        return sp

    def span(self, name: str, cat: str = "span",
             rank: Optional[int] = None, **args) -> _SpanCtx:
        return _SpanCtx(self, self.begin(name, cat, rank=rank, **args))

    # ---------------------------------------------------------------- #
    # queries
    # ---------------------------------------------------------------- #
    def spans(self, cat: Optional[str] = None,
              name: Optional[str] = None) -> Iterator[Span]:
        for e in self.events:
            if cat is not None and e.cat != cat:
                continue
            if name is not None and e.name != name:
                continue
            yield e

    def flight(self, last_ticks: int) -> List[Span]:
        """The flight-recorder window: every event whose end lands in
        the last ``last_ticks`` ticks (inclusive of the current one)."""
        lo = self.tick - last_ticks + 1
        return [e for e in self.events if e.tick1 >= lo]

    def request_stats(self) -> Dict[Any, Dict[str, float]]:
        """Derive per-request timing from lifecycle events — TTFT, TPOT
        and end-to-end latency become trace queries instead of
        hand-maintained timers on the Request object.

        Consumes ``cat="req"`` instants: ``req_submit``,
        ``req_first_token`` and ``req_retire`` (the latter carrying
        ``tokens=<generated count>``).  Returns seconds, keyed by rid.

        Lifecycle edge cases are first-class: a preempted-and-resumed
        (or recompute-replayed) request's ``req_preempt``/``req_resume``
        instants land in ``preempts`` / ``resumes`` counts (with
        ``preempt_modes`` naming swap vs recompute), and a request still
        in flight at dump time has ``state="in-flight"`` with no
        ``latency_s``/``tpot_s`` — its ``ttft_s`` still derives when the
        first token already exists.  TTFT/latency are unchanged by
        preemption (first-token-wins; the retire instant is terminal).
        """
        out: Dict[Any, Dict[str, float]] = {}
        for e in self.events:
            if e.cat != "req":
                continue
            rid = e.args.get("rid")
            if rid is None:
                continue
            rec = out.setdefault(rid, {})
            if e.name == "req_submit":
                rec["t_submit_us"] = e.t0_us
            elif e.name == "req_first_token":
                rec.setdefault("t_first_us", e.t0_us)
            elif e.name == "req_retire":
                rec["t_retire_us"] = e.t0_us
                rec["tokens"] = e.args.get("tokens", 0)
            elif e.name == "req_preempt":
                rec["preempts"] = rec.get("preempts", 0) + 1
                rec.setdefault("preempt_modes", []).append(
                    e.args.get("mode", "?"))
            elif e.name == "req_resume":
                rec["resumes"] = rec.get("resumes", 0) + 1
        for rec in out.values():
            rec["state"] = ("retired" if "t_retire_us" in rec
                            else "in-flight")
            t0 = rec.get("t_submit_us")
            tf = rec.get("t_first_us")
            td = rec.get("t_retire_us")
            if t0 is not None and tf is not None:
                rec["ttft_s"] = (tf - t0) / 1e6
            if t0 is not None and td is not None:
                rec["latency_s"] = (td - t0) / 1e6
            if tf is not None and td is not None:
                n = rec.get("tokens", 0)
                rec["tpot_s"] = (td - tf) / 1e6 / max(n - 1, 1)
        return out


# -------------------------------------------------------------------- #
# module-level switch
# -------------------------------------------------------------------- #
_NULL = NullTracer()
_ACTIVE: Any = _NULL


def active() -> Any:
    """The current recorder — a :class:`Tracer` when enabled, the no-op
    :class:`NullTracer` otherwise.  Hot paths call this then guard on
    ``.enabled``."""
    return _ACTIVE


def enable(tracer: Optional[Tracer] = None, **kw) -> Tracer:
    """Install (and return) the active tracer.  ``kw`` is forwarded to
    the :class:`Tracer` constructor when none is passed."""
    global _ACTIVE
    _ACTIVE = tracer if tracer is not None else Tracer(**kw)
    return _ACTIVE


def disable() -> Optional[Tracer]:
    """Swap the no-op recorder back in; returns the tracer that was
    active (so callers can still export it), or None."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = _NULL
    return None if prev is _NULL else prev
