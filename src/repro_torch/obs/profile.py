"""Device-time kernel profiling: the measurement side of the cost loop.

Port of ``repro.obs.profile``.  The tracer records host walls around
initiation and sync, good enough to fit α/β from end-to-end transfer
spans but blind to γ, the receiver-side epilogue per KiB, which overlaps
the wire by design.  This module times the epilogue program alone at
several sizes and hands its per-KiB slope to
:meth:`repro_torch.core.sched.EngineCost.fit_from_trace` as
``epilogue_spans``; it also times kernels against their plain versions
and the server's decode step.

Measurement discipline:

- **Device clocks on the card.**  A target on CUDA is timed with CUDA
  events around one call, with a sleep kernel queued ahead of the start
  event, so the device reaches the start event only once the host has
  enqueued the call and the stop event: the events time the device's
  work, not the host's dispatch.  Where the device reached the start
  event first, the sleep is doubled and the call timed again.  A call of
  more launches than the device's launch queue holds (an eager decode
  step of thousands of kernels) cannot wait behind any sleep: the host
  blocks on the full queue and the device then idles between its
  launches.  Such a target is timed by the durations of its kernels
  under ``torch.profiler`` (the device's busy time in the call) once the
  longest sleep has failed.  Either sample is labelled
  ``measured="device"``, its ``clock`` tag ``"events"`` or
  ``"kernels"``.
- **Wall clock on the CPU**: ``perf_counter`` around a call, labelled
  ``measured="wall"``.
- **Best of N, interleaved.**  ``profile_many`` times its targets
  round-robin, so load drift lands on all of them alike, and keeps each
  one's best (noise only ever adds time).
- **Never on the serving hot path**: profiling re-executes a target
  offline.

Like the rest of ``repro_torch.obs`` this module imports nothing from
the core or serving layers; servers and benches hand it plain callables.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import torch

from repro_torch.compat import resolve_device
from repro_torch.obs import trace as obs_trace

__all__ = [
    "DeviceProfiler",
    "device_events_available",
    "measure",
]

_FIRST_SLEEP_CYCLES = 1 << 21  # the sleep ahead of the start event
_MAX_SLEEP_CYCLES = 1 << 30  # ~0.5 s: longer than any enqueue that fits


def _device(device: Any = None) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


def device_events_available(device: Any = None) -> bool:
    """True when ``device`` (default: CUDA if present, else the CPU) has
    on-device timers: a CUDA device.  Samples elsewhere are wall-clocked
    re-executions, marked ``measured="wall"``."""
    return _device(device).type == "cuda" and torch.cuda.is_available()


def _kernels_us(fn: Callable[[], Any], tries: int = 5) -> float:
    """The summed durations of the device work of one call of ``fn``
    under ``torch.profiler`` (a session that saw none is retried: the
    profiler drops a session's records now and then)."""
    for _ in range(tries):
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        with prof:
            fn()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            return float(sum(spans))
    raise RuntimeError("torch.profiler saw no device work of the call")


class _Clock:
    """Times one target, call after call (see the module docstring)."""

    def __init__(self, events: bool):
        self.events = events
        self.cycles = _FIRST_SLEEP_CYCLES
        self.name = "events" if events else "wall"

    def __call__(self, fn: Callable[[], Any]) -> float:
        if not self.events:
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e6
        while self.name == "events":
            torch.cuda._sleep(self.cycles)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            late = e0.query()  # the device reached the start first
            e1.synchronize()
            if not late:
                return e0.elapsed_time(e1) * 1e3
            if self.cycles >= _MAX_SLEEP_CYCLES:
                self.name = "kernels"
            else:
                self.cycles *= 2
        return _kernels_us(fn)


def _warm(fn: Callable[[], Any], warmup: int, events: bool) -> None:
    for _ in range(max(warmup, 0)):
        fn()
    if events:
        torch.cuda.synchronize()


def _measure(fn, iters, warmup, device) -> tuple:
    clock = _Clock(device_events_available(device))
    _warm(fn, warmup, clock.events)
    best = min(clock(fn) for _ in range(max(iters, 1)))
    return best, clock


def _tags(clock: "_Clock") -> Dict[str, Any]:
    if not clock.events:
        return {"measured": "wall"}
    return {"measured": "device", "clock": clock.name}


def measure(
    fn: Callable[[], Any],
    *,
    iters: int = 8,
    warmup: int = 2,
    device: Any = None,
) -> tuple:
    """Time ``fn()`` by re-execution: ``warmup`` unrecorded calls, then
    ``iters`` timed calls.  Returns ``(best_us, measured)`` where
    ``measured`` names the clock (``"device"`` | ``"wall"``)."""
    best, clock = _measure(fn, iters, warmup, device)
    return best, _tags(clock)["measured"]


class DeviceProfiler:
    """Records timed kernel/program samples as profile spans.

    Each :meth:`profile` call produces one record, a plain dict with
    ``name`` / ``dur_us`` / ``measured`` plus caller tags (``bytes=``
    makes it a valid fit point for
    :meth:`~repro_torch.core.sched.EngineCost.fit_from_trace`), kept on
    ``self.records`` and, when tracing is enabled, mirrored onto the
    active tracer as a ``cat="profile"`` instant.  ``device`` says where
    the targets run: CUDA unless the caller names another device.
    """

    def __init__(self, tracer: Optional[Any] = None, device: Any = None):
        self._tracer = tracer
        self.device = resolve_device(device)
        self.records: List[Dict[str, Any]] = []

    def _emit(self, rec: Dict[str, Any]) -> None:
        self.records.append(rec)
        tr = self._tracer if self._tracer is not None else obs_trace.active()
        if tr.enabled:
            tr.instant(rec["name"], cat="profile",
                       **{k: v for k, v in rec.items() if k != "name"})

    # ---------------------------------------------------------------- #
    def profile(
        self,
        name: str,
        fn: Callable[[], Any],
        *,
        iters: int = 8,
        warmup: int = 2,
        **tags: Any,
    ) -> float:
        """Time one target; returns its best-of-N microseconds."""
        best_us, clock = _measure(fn, iters, warmup, self.device)
        self._emit({"name": name, "dur_us": round(best_us, 3),
                    **_tags(clock), **tags})
        return best_us

    def profile_many(
        self,
        targets: Sequence[tuple],
        *,
        rounds: int = 6,
        warmup: int = 2,
    ) -> Dict[str, float]:
        """Interleaved timed re-execution of several targets.

        ``targets`` is a sequence of ``(name, fn)`` or ``(name, fn,
        tags)`` tuples.  Each round times every target once,
        round-robin; per-target best-of-rounds is recorded.  Returns
        ``{name: best_us}``."""
        norm = [(t[0], t[1], t[2] if len(t) > 2 else {}) for t in targets]
        events = device_events_available(self.device)
        clocks = {name: _Clock(events) for name, _, _ in norm}
        for _, fn, _ in norm:
            _warm(fn, warmup, events)
        best: Dict[str, float] = {}
        for _ in range(max(rounds, 1)):
            for name, fn, _ in norm:
                dt = clocks[name](fn)
                if name not in best or dt < best[name]:
                    best[name] = dt
        for name, _, tags in norm:
            self._emit({"name": name, "dur_us": round(best[name], 3),
                        **_tags(clocks[name]), **tags})
        return best

    def profile_epilogue(
        self,
        make_fn: Callable[[int], Callable[[], Any]],
        sizes: Iterable[int],
        *,
        name: str = "epilogue",
        iters: int = 8,
        warmup: int = 2,
    ) -> List[Dict[str, Any]]:
        """Time the receiver-epilogue program alone at several payload
        sizes: the γ measurement.  ``make_fn(nbytes)`` returns a zero-arg
        callable running the epilogue over ``nbytes``.  The records carry
        ``bytes`` tags and feed ``EngineCost.fit_from_trace(...,
        epilogue_spans=...)`` / ``fit_gamma_from_trace`` directly."""
        out = []
        for nbytes in sizes:
            fn = make_fn(int(nbytes))
            best_us, clock = _measure(fn, iters, warmup, self.device)
            rec = {"name": name, "dur_us": round(best_us, 3),
                   **_tags(clock), "bytes": int(nbytes)}
            self._emit(rec)
            out.append(rec)
        return out

    # ---------------------------------------------------------------- #
    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        """Recorded samples (optionally filtered by name): dict-shaped
        fit points accepted by ``EngineCost._points``."""
        if name is None:
            return list(self.records)
        return [r for r in self.records if r["name"] == name]
