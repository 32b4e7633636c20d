"""Merge per-rank trace streams into Chrome-trace JSON + flight dumps.

Counterpart of ``repro.obs.export`` over the port's tracer: the same
events give the same dicts, and the fields the port's ``Span`` adds
(the annotating tracer's profiler range) are not exported.

The export clocks everything on the deterministic tick clock: an event
at tick T with per-tick sequence s lands at ``ts = T*1000 + s`` virtual
microseconds, so every rank's tick-T activity lines up in one column of
the timeline regardless of host wall time, and begin/end sequence
numbers guarantee scoped spans nest strictly.  Wall-clock durations
(``dur_us``) ride along in ``args`` for real measurements.

Rows: one ``tid`` per rank, plus row 0 (``gas``) for program-wide
transport/collective events that aren't attributable to a single rank
(an ``all_to_all`` belongs to everyone).  Scoped spans export as
complete (``ph="X"``) events; split-phase RMA spans as async
(``ph="b"/"e"``) pairs riding their span id; fault-tolerance events
(rank death, heartbeat miss, quorum restore, elastic join) as instant
(``ph="i"``) events with global scope so they draw a line across the
whole timeline.

``validate`` re-checks the two invariants the acceptance gate cares
about: complete spans nest per row, and the per-op byte totals summed
from exported RMA spans are bit-equal to the tracer's migrated metrics
counters.

``flight_dump`` is the chaos postmortem: the ring's last N ticks plus
the replay seed, small enough to drop into a CI step summary.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Union

from repro_torch.obs.trace import Span, Tracer

__all__ = [
    "chrome_trace",
    "event_dict",
    "flight_dump",
    "render_flight_summary",
    "validate",
    "write_trace",
]

# per-tick sequence numbers are folded into a 1000-slot window per tick;
# a tick with more host events than this still exports (clamped), it
# just stops being strictly ordered within the overflow tail.
_TICK_WINDOW = 1000


def _ts(tick: int, seq: int) -> int:
    return tick * _TICK_WINDOW + min(seq, _TICK_WINDOW - 1)


def _tid(rank: Optional[int]) -> int:
    return 0 if rank is None else int(rank) + 1


def event_dict(e: Span) -> Dict[str, Any]:
    """Raw (lossless) dict form of one recorded event — the flight-dump
    payload, and handy for jq-style offline queries."""
    return {
        "sid": e.sid,
        "name": e.name,
        "cat": e.cat,
        "kind": e.kind,
        "rank": e.rank,
        "tick0": e.tick0,
        "seq0": e.seq0,
        "tick1": e.tick1,
        "seq1": e.seq1,
        "t0_us": round(e.t0_us, 3),
        "dur_us": round(e.dur_us, 3),
        "args": e.args,
    }


def chrome_trace(
    tracers: Union[Tracer, Sequence[Tracer]],
    labels: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Merge one or more per-rank tracer streams into a Chrome-trace
    dict (``{"traceEvents": [...]}`` — load in chrome://tracing or
    https://ui.perfetto.dev).  Multiple streams land as separate pids
    merged on the shared tick clock."""
    if isinstance(tracers, Tracer):
        tracers = [tracers]
    events: List[Dict[str, Any]] = []
    ranks_seen: Dict[int, set] = {}
    for pid, tr in enumerate(tracers):
        seen = ranks_seen.setdefault(pid, set())
        for e in tr.events:
            tid = _tid(e.rank)
            seen.add(tid)
            args = dict(e.args)
            args["tick"] = e.tick0
            base = {
                "name": e.name,
                "cat": e.cat,
                "pid": pid,
                "tid": tid,
            }
            if e.kind == "instant":
                events.append({
                    **base, "ph": "i", "ts": _ts(e.tick0, e.seq0),
                    "s": "g" if e.cat == "ft" else "t", "args": args,
                })
            elif e.kind == "async":
                args["dur_us"] = round(e.dur_us, 3)
                events.append({
                    **base, "ph": "b", "id": e.sid,
                    "ts": _ts(e.tick0, e.seq0), "args": args,
                })
                events.append({
                    **base, "ph": "e", "id": e.sid,
                    "ts": _ts(e.tick1, e.seq1),
                })
            else:
                t0 = _ts(e.tick0, e.seq0)
                t1 = _ts(e.tick1, e.seq1)
                args["dur_us"] = round(e.dur_us, 3)
                events.append({
                    **base, "ph": "X", "ts": t0,
                    "dur": max(t1 - t0, 1), "args": args,
                })
    # row names so the viewer shows "rank N" instead of bare tids
    meta: List[Dict[str, Any]] = []
    for pid, tids in ranks_seen.items():
        label = labels[pid] if labels else f"stream{pid}"
        meta.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": label},
        })
        for tid in sorted(tids):
            meta.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": "gas" if tid == 0 else f"rank{tid - 1}"},
            })
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"clock": "tick*1000+seq (virtual us)"},
    }


# -------------------------------------------------------------------- #
# validation
# -------------------------------------------------------------------- #
def validate(trace: Dict[str, Any], registry=None) -> List[str]:
    """Check the exported trace; returns a list of problems (empty =
    valid).

    - complete (``X``) spans must nest properly within each row;
    - async (``b``/``e``) pairs must match up, with ``e`` not before
      ``b``;
    - when ``registry`` is given (the tracer's metrics registry), the
      per-op byte totals summed over exported RMA spans must be
      bit-equal to the ``rma_<op>_bytes``/``rma_<op>_ops`` counters.
    """
    problems: List[str] = []
    events = trace.get("traceEvents", [])

    # --- X nesting per row ---
    by_row: Dict[tuple, List[dict]] = {}
    for ev in events:
        if ev.get("ph") == "X":
            by_row.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    for row, evs in sorted(by_row.items()):
        evs.sort(key=lambda ev: (ev["ts"], -ev["dur"]))
        stack: List[tuple] = []  # (end_ts, name)
        for ev in evs:
            t0, t1 = ev["ts"], ev["ts"] + ev["dur"]
            while stack and stack[-1][0] <= t0:
                stack.pop()
            if stack and t1 > stack[-1][0]:
                problems.append(
                    f"row {row}: span {ev['name']!r} [{t0},{t1}) "
                    f"overlaps parent {stack[-1][1]!r} ending at "
                    f"{stack[-1][0]}"
                )
            stack.append((t1, ev["name"]))

    # --- async pairing ---
    opens: Dict[tuple, dict] = {}
    pairs: List[tuple] = []
    for ev in events:
        ph = ev.get("ph")
        if ph == "b":
            key = (ev["pid"], ev["cat"], ev["id"])
            if key in opens:
                problems.append(f"async span id {ev['id']} opened twice")
            opens[key] = ev
        elif ph == "e":
            key = (ev["pid"], ev["cat"], ev["id"])
            b = opens.pop(key, None)
            if b is None:
                problems.append(
                    f"async end id {ev['id']} without a begin"
                )
            else:
                if ev["ts"] < b["ts"]:
                    problems.append(
                        f"async span {b['name']!r} id {ev['id']} ends "
                        f"before it begins"
                    )
                pairs.append((b, ev))
    for key, b in opens.items():
        problems.append(
            f"async span {b['name']!r} id {key[2]} never ended "
            f"(initiated but never synced)"
        )

    # --- RMA byte totals vs the migrated metrics counters ---
    if registry is not None:
        sums: Dict[str, int] = {}
        ops: Dict[str, int] = {}
        for b, _e in pairs:
            if b.get("cat") != "rma":
                continue
            nbytes = b.get("args", {}).get("bytes")
            if nbytes is None:
                problems.append(
                    f"rma span {b['name']!r} id {b['id']} has no bytes tag"
                )
                continue
            sums[b["name"]] = sums.get(b["name"], 0) + int(nbytes)
            ops[b["name"]] = ops.get(b["name"], 0) + 1
        counted = {
            m.name for m in registry
            if m.kind == "counter" and m.name.startswith("rma_")
            and m.name.endswith("_bytes")
        }
        for op in sorted(set(sums) | {
            n[len("rma_"):-len("_bytes")] for n in counted
        }):
            want_b = registry.counter(f"rma_{op}_bytes").get()
            want_n = registry.counter(f"rma_{op}_ops").get()
            got_b, got_n = sums.get(op, 0), ops.get(op, 0)
            if got_b != want_b or got_n != want_n:
                problems.append(
                    f"rma {op!r}: trace total {got_b}B/{got_n} ops != "
                    f"counter {want_b}B/{want_n} ops (byte accounting "
                    f"must be bit-equal)"
                )
    return problems


# -------------------------------------------------------------------- #
# flight recorder
# -------------------------------------------------------------------- #
def flight_dump(tracer: Tracer, last_ticks: int = 64, *,
                reason: str = "", seed: Optional[int] = None,
                rank: Optional[int] = None) -> Dict[str, Any]:
    """Dump the ring's last ``last_ticks`` ticks — triggered on rank
    death (and on chaos-scenario failure) so a postmortem sees what the
    cluster was doing when it died, plus the seed to replay it."""
    return {
        "reason": reason,
        "tick": tracer.tick,
        "last_ticks": last_ticks,
        "seed": seed,
        "rank": rank,
        "events": [event_dict(e) for e in tracer.flight(last_ticks)],
        "metrics": tracer.registry.snapshot(),
    }


def render_flight_summary(dump: Dict[str, Any],
                          max_events: int = 40) -> str:
    """Markdown rendering of a flight dump for ``GITHUB_STEP_SUMMARY``."""
    lines = [
        f"### flight recorder — {dump.get('reason') or 'dump'} "
        f"at tick {dump.get('tick')}",
    ]
    if dump.get("seed") is not None:
        lines.append(
            f"replay: `python -m repro_torch.testing.fault_suite "
            f"--seed {dump['seed']}`"
        )
    events = dump.get("events", [])
    lines.append(
        f"last {dump.get('last_ticks')} ticks, "
        f"{len(events)} events (showing {min(len(events), max_events)}):"
    )
    lines.append("")
    lines.append("| tick | rank | kind | cat | name | args |")
    lines.append("|---|---|---|---|---|---|")
    for e in events[-max_events:]:
        rank = "gas" if e["rank"] is None else e["rank"]
        args = {
            k: v for k, v in e.get("args", {}).items()
            if k not in ("dur_us",)
        }
        lines.append(
            f"| {e['tick0']} | {rank} | {e['kind']} | {e['cat']} "
            f"| {e['name']} | `{json.dumps(args, default=str)}` |"
        )
    return "\n".join(lines)


def write_trace(trace: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(trace, f, indent=None, separators=(",", ":"))
        f.write("\n")
