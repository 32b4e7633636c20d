"""Per-request critical-path attribution: where did this request's time go?

Counterpart of ``repro.obs.attrib``; ``cost`` is the port's
``repro_torch.core.sched.EngineCost`` (on the card, the constants
``sched.measure_costs`` fitted).

GASNet postmortems answer "which transfer hung" by replaying a
``GASNET_TRACE`` log against the program's structure; the serving
analogue of that question is *which segment of a request's lifecycle
dominated its latency* -- and the tracer already records everything
needed to answer it: the lifecycle instants (``req_submit`` /
``req_first_token`` / ``req_admit`` / ``req_preempt`` / ``req_resume``
/ ``req_retire``), the per-request ``prefill`` span, and the tick-phase
spans around them.  This module folds those events into a per-request
breakdown over seven segments:

==================  ====================================================
queue               submit -> prefill start (or first admission when the
                    server prefills inline)
prefill             the request's own prefill span(s) before first
                    admission
handoff_wire /      prefill end -> decode admission (the KV transfer
handoff_epilogue    window in the disaggregated cluster), split by the
                    cost model's measured β : γ ratio when one is given
decode              resident decode time (admission -> retirement, minus
                    evicted windows)
swap                evicted windows whose preemption chose ``swap``
replay              evicted windows whose preemption chose ``recompute``
                    (plus any re-prefill spans the replay paid)
==================  ====================================================

:func:`why_slow` then names the dominant segment and the co-resident
requests whose residency overlapped it — the convoy a victim sat
behind.  Everything here is a pure fold over a :class:`Tracer`'s ring;
nothing is recorded, so it can run post-hoc on a flight dump's worth of
events.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Breakdown",
    "attribute",
    "why_slow",
]

SEGMENTS = (
    "queue", "prefill", "handoff_wire", "handoff_epilogue",
    "decode", "swap", "replay",
)


@dataclasses.dataclass
class Breakdown:
    """One request's lifecycle, folded into segment walls (us)."""

    rid: Any
    state: str  # "retired" | "in-flight"
    total_us: float
    segments: Dict[str, float]
    n_preempts: int
    # wall windows (t0_us, t1_us) backing the non-derived segments —
    # what why_slow intersects against other requests' residency
    windows: Dict[str, List[Tuple[float, float]]]
    # residency: admitted/resumed -> preempted/retired intervals
    resident: List[Tuple[float, float]]

    def dominant(self) -> str:
        return max(SEGMENTS, key=lambda s: self.segments.get(s, 0.0))

    def share(self, seg: str) -> float:
        return self.segments.get(seg, 0.0) / self.total_us \
            if self.total_us > 0 else 0.0


def _fold_events(events) -> Dict[Any, Dict[str, Any]]:
    """Group the request-lifecycle events by rid, time-ordered."""
    per: Dict[Any, Dict[str, Any]] = {}
    for e in events:
        if e.cat != "req":
            continue
        rid = e.args.get("rid")
        if rid is None:
            continue
        rec = per.setdefault(rid, {
            "submit": None, "first": None, "retire": None,
            "prefills": [], "admits": [], "preempts": [], "resumes": [],
            "last_seen": 0.0,
        })
        rec["last_seen"] = max(rec["last_seen"], e.t1_us)
        if e.name == "req_submit":
            rec["submit"] = e.t0_us
        elif e.name == "req_first_token":
            if rec["first"] is None:
                rec["first"] = e.t0_us
        elif e.name == "req_retire":
            rec["retire"] = e.t0_us
        elif e.name == "prefill":
            rec["prefills"].append((e.t0_us, e.t1_us))
        elif e.name == "req_admit":
            rec["admits"].append(e.t0_us)
        elif e.name == "req_resume":
            rec["resumes"].append(e.t0_us)
        elif e.name == "req_preempt":
            rec["preempts"].append((e.t0_us, e.args.get("mode", "swap")))
    return per


def attribute(tracer, cost: Optional[Any] = None) -> Dict[Any, Breakdown]:
    """Fold the tracer's request-lifecycle events into per-rid
    :class:`Breakdown` objects.

    ``cost`` (an :class:`~repro_torch.core.sched.EngineCost`) splits the
    handoff window into wire vs epilogue by its measured β : γ ratio;
    without one the whole window is attributed to the wire."""
    out: Dict[Any, Breakdown] = {}
    for rid, rec in _fold_events(tracer.events).items():
        t_submit = rec["submit"]
        if t_submit is None:
            continue
        t_end = rec["retire"] if rec["retire"] is not None \
            else rec["last_seen"]
        state = "retired" if rec["retire"] is not None else "in-flight"
        total = max(t_end - t_submit, 0.0)
        segs = {s: 0.0 for s in SEGMENTS}
        windows: Dict[str, List[Tuple[float, float]]] = \
            {s: [] for s in SEGMENTS}

        first_admit = min(rec["admits"]) if rec["admits"] else None
        # prefill spans before first admission are the request's own
        # prefill; later ones are recompute re-prefills -> replay
        for p0, p1 in sorted(rec["prefills"]):
            if first_admit is None or p0 <= first_admit:
                segs["prefill"] += p1 - p0
                windows["prefill"].append((p0, p1))
            else:
                segs["replay"] += p1 - p0
                windows["replay"].append((p0, p1))

        own_prefills = windows["prefill"]
        if own_prefills:
            q_end = own_prefills[0][0]
            handoff0 = own_prefills[-1][1]
        else:
            q_end = first_admit if first_admit is not None else t_end
            handoff0 = None
        segs["queue"] = max(q_end - t_submit, 0.0)
        windows["queue"].append((t_submit, q_end))
        if handoff0 is not None and first_admit is not None \
                and first_admit > handoff0:
            hand = first_admit - handoff0
            wire_frac = 1.0
            if cost is not None:
                denom = cost.beta_us_per_kib + cost.gamma_us_per_kib
                if denom > 0:
                    wire_frac = cost.beta_us_per_kib / denom
            segs["handoff_wire"] = hand * wire_frac
            segs["handoff_epilogue"] = hand * (1.0 - wire_frac)
            windows["handoff_wire"].append((handoff0, first_admit))
            windows["handoff_epilogue"].append((handoff0, first_admit))

        # pair each preemption with the resume/re-admission that ends it
        reentries = sorted(rec["resumes"] + [
            t for t in rec["admits"]
            if first_admit is None or t > first_admit
        ])
        evicted = 0.0
        for t_p, mode in sorted(rec["preempts"]):
            t_r = next((t for t in reentries if t > t_p), t_end)
            seg = "swap" if mode == "swap" else "replay"
            segs[seg] += max(t_r - t_p, 0.0)
            windows[seg].append((t_p, t_r))
            evicted += max(t_r - t_p, 0.0)

        if first_admit is not None:
            # evicted windows already contain any re-prefill spans the
            # replay paid, so subtracting them once is exact
            resident_total = max(t_end - first_admit, 0.0)
            segs["decode"] = max(resident_total - evicted, 0.0)
            windows["decode"].append((first_admit, t_end))

        # residency intervals: admitted/resumed -> preempted/retired
        starts = sorted(rec["admits"] + rec["resumes"])
        stops = sorted([t for t, _ in rec["preempts"]]
                       + ([rec["retire"]] if rec["retire"] is not None
                          else []))
        resident = []
        for s in starts:
            e = next((t for t in stops if t > s), t_end)
            resident.append((s, e))

        out[rid] = Breakdown(
            rid=rid, state=state, total_us=total, segments=segs,
            n_preempts=len(rec["preempts"]), windows=windows,
            resident=resident,
        )
    return out


def _overlap(a: Tuple[float, float], b: Tuple[float, float]) -> float:
    return max(0.0, min(a[1], b[1]) - max(a[0], b[0]))


def why_slow(
    tracer,
    rid: Any,
    cost: Optional[Any] = None,
    top: int = 4,
) -> str:
    """The postmortem report: name the dominant lifecycle segment of
    ``rid`` and the co-resident requests that convoyed it.

    The convoy set is computed against the dominant segment's wall
    window: every other request whose residency (admitted -> preempted
    or retired) overlaps that window held decode capacity — slots,
    pool pages — while ``rid`` waited in it."""
    downs = attribute(tracer, cost=cost)
    if rid not in downs:
        return f"why_slow(rid={rid}): no lifecycle events recorded"
    bd = downs[rid]
    dom = bd.dominant()
    dom_windows = bd.windows.get(dom) or [(0.0, 0.0)]
    # the longest window of the dominant segment is the stall to explain
    stall = max(dom_windows, key=lambda w: w[1] - w[0])

    lines = [
        f"why_slow(rid={rid}): {bd.state}, total "
        f"{bd.total_us / 1e3:.2f}ms, {bd.n_preempts} preemption(s) — "
        f"dominant: {dom} "
        f"({bd.share(dom) * 100:.0f}%, {bd.segments[dom] / 1e3:.2f}ms)"
    ]
    for seg in SEGMENTS:
        v = bd.segments.get(seg, 0.0)
        if v <= 0.0:
            continue
        lines.append(
            f"  {seg:<17s} {v / 1e3:9.2f}ms  {bd.share(seg) * 100:5.1f}%"
        )
    convoy = []
    for other_rid, other in downs.items():
        if other_rid == rid:
            continue
        ov = sum(_overlap(stall, w) for w in other.resident)
        if ov > 0.0:
            convoy.append((ov, other_rid, other.state))
    convoy.sort(reverse=True)
    if convoy:
        lines.append(
            f"  convoyed by (co-resident during the {dom} window "
            f"[{stall[0] / 1e3:.2f}, {stall[1] / 1e3:.2f}]ms):"
        )
        for ov, other_rid, state in convoy[:top]:
            lines.append(
                f"    rid {other_rid}: resident {ov / 1e3:.2f}ms "
                f"of the window ({state})"
            )
    else:
        lines.append("  no co-resident requests during the dominant window")
    return "\n".join(lines)
