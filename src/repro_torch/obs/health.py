"""Live SLO health: deadline-risk gauges, at-risk instants, backpressure.

The port of ``repro.obs.health``.  The attribution module
(``repro_torch.obs.attrib``) answers *after the fact* where a
request's time went; this monitor answers the live
question — *is the cluster about to miss its SLOs?* — on the same tick
clock the tracer merges ranks on.  Per tracked request it projects:

- **TTFT** — elapsed wait vs the request's ``ttft_deadline_s`` while no
  first token exists yet;
- **TPOT** — the larger of the observed inter-token EWMA and the
  current stall (time since the last token) vs ``tpot_deadline_s``.

A projection crossing ``risk_frac`` of its deadline emits one
``slo_at_risk`` trace instant (cat ``"slo"``) and enters the at-risk
set; crossing the deadline itself emits ``slo_violated`` and counts on
the registry.  With ``risk_frac < 1`` and a monitor clocked every tick,
``slo_at_risk`` fires strictly before the violation tick — the early
warning the scheduler can still act on: the **backpressure floor**
(:meth:`backpressure_floor`, the highest at-risk priority) tells the
:class:`~repro_torch.serving.scheduler.AdmissionScheduler` to defer admitting
work below that priority until the at-risk set drains, so a deadline-
critical request stops competing with bulk traffic for pool pages.

Deadlines default to ``inf`` (:class:`~repro_torch.serving.scheduler.SLO`),
so an always-wired monitor is inert until a request actually carries
one — risk is 0, the at-risk set stays empty, no admission is ever
deferred.  All clocks are injected (``now`` parameters), which is what
makes the pressure scenarios deterministic under test.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import Registry

__all__ = [
    "HealthMonitor",
]


@dataclasses.dataclass
class _Tracked:
    rid: Any
    priority: int
    ttft_deadline_s: float
    tpot_deadline_s: float
    t_submit: float
    t_first: Optional[float] = None
    t_last_token: Optional[float] = None
    tokens: int = 0
    tpot_ewma_s: Optional[float] = None
    at_risk: bool = False
    violated: bool = False


class HealthMonitor:
    """Tick-clocked SLO monitor (see module docstring).

    ``backpressure=False`` keeps the monitor observing (risk gauges,
    instants, violation counts) without ever raising the admission
    floor — the A/B control arm of the oversubscription bench."""

    def __init__(
        self,
        registry: Optional[Registry] = None,
        *,
        risk_frac: float = 0.8,
        ewma: float = 0.25,
        backpressure: bool = True,
    ):
        if not 0.0 < risk_frac <= 1.0:
            raise ValueError(f"risk_frac must be in (0, 1], got {risk_frac}")
        self.registry = registry if registry is not None else Registry()
        self.risk_frac = risk_frac
        self.ewma_alpha = ewma
        self.backpressure = backpressure
        self._reqs: Dict[Any, _Tracked] = {}
        self.last_summary: Dict[str, Any] = {}

    # ---------------------------------------------------------------- #
    # lifecycle feed (the serving layers call these)
    # ---------------------------------------------------------------- #
    def track(self, rid: Any, slo: Any, now: float) -> None:
        """Start monitoring one request against its SLO deadlines."""
        self._reqs[rid] = _Tracked(
            rid=rid,
            priority=int(getattr(slo, "priority", 0) or 0),
            ttft_deadline_s=float(
                getattr(slo, "ttft_deadline_s", math.inf)),
            tpot_deadline_s=float(
                getattr(slo, "tpot_deadline_s", math.inf)),
            t_submit=now,
        )

    def first_token(self, rid: Any, now: float) -> None:
        t = self._reqs.get(rid)
        if t is not None and t.t_first is None:
            t.t_first = now
            t.t_last_token = now
            t.tokens = 1

    def progress(self, rid: Any, tokens: int, now: float) -> None:
        """Observed generated-token count for a tracked request; the
        inter-token gap feeds the TPOT EWMA."""
        t = self._reqs.get(rid)
        if t is None or tokens <= t.tokens:
            return
        if t.t_last_token is not None and tokens > t.tokens:
            gap = (now - t.t_last_token) / (tokens - t.tokens)
            if t.tpot_ewma_s is None:
                t.tpot_ewma_s = gap
            else:
                a = self.ewma_alpha
                t.tpot_ewma_s = a * gap + (1.0 - a) * t.tpot_ewma_s
        t.tokens = tokens
        t.t_last_token = now

    def retire(self, rid: Any) -> None:
        self._reqs.pop(rid, None)

    # ---------------------------------------------------------------- #
    def _risk(self, t: _Tracked, now: float) -> tuple:
        """(risk fraction, which deadline) for one tracked request —
        risk >= 1.0 means the deadline has passed."""
        if t.t_first is None:
            if math.isfinite(t.ttft_deadline_s) and t.ttft_deadline_s > 0:
                return (now - t.t_submit) / t.ttft_deadline_s, "ttft"
            return 0.0, "ttft"
        if math.isfinite(t.tpot_deadline_s) and t.tpot_deadline_s > 0:
            stall = (now - t.t_last_token) if t.t_last_token is not None \
                else 0.0
            proj = max(t.tpot_ewma_s or 0.0, stall)
            return proj / t.tpot_deadline_s, "tpot"
        return 0.0, "tpot"

    def tick(
        self,
        tick_no: int,
        now: float,
        progress: Optional[Dict[Any, int]] = None,
        retired: Optional[Iterable[Any]] = None,
    ) -> Dict[str, Any]:
        """One monitor step on the cluster's tick clock.

        ``progress`` maps rid -> generated-token count for currently
        resident requests (fed through :meth:`progress`); ``retired``
        drops finished rids.  Recomputes every projection, emits
        ``slo_at_risk`` / ``slo_violated`` instants on transitions,
        publishes the gauges, and returns (and stores on
        :attr:`last_summary`) the per-tick health summary."""
        if retired is not None:
            for rid in retired:
                self.retire(rid)
        if progress is not None:
            for rid, tokens in progress.items():
                self.progress(rid, tokens, now)

        tr = obs_trace.active()
        risk_by_prio: Dict[int, float] = {}
        at_risk: List[Any] = []
        violated: List[Any] = []
        for t in self._reqs.values():
            risk, kind = self._risk(t, now)
            prev = risk_by_prio.get(t.priority, 0.0)
            risk_by_prio[t.priority] = max(prev, risk)
            if risk >= 1.0:
                at_risk.append(t.rid)
                violated.append(t.rid)
                if not t.violated:
                    t.violated = True
                    self.registry.counter("slo_violations").inc()
                    if tr.enabled:
                        tr.instant(
                            "slo_violated", cat="slo", rid=t.rid,
                            deadline=kind, priority=t.priority,
                            risk=round(risk, 3),
                        )
            elif risk >= self.risk_frac:
                at_risk.append(t.rid)
                if not t.at_risk:
                    t.at_risk = True
                    if tr.enabled:
                        tr.instant(
                            "slo_at_risk", cat="slo", rid=t.rid,
                            deadline=kind, priority=t.priority,
                            risk=round(risk, 3),
                        )
            else:
                t.at_risk = False

        for prio, risk in risk_by_prio.items():
            self.registry.gauge(f"slo_risk_p{prio}").set(round(risk, 4))
        self.registry.gauge("slo_at_risk").set(len(at_risk))

        self.last_summary = {
            "tick": tick_no,
            "tracked": len(self._reqs),
            "at_risk": sorted(at_risk, key=repr),
            "violated": sorted(violated, key=repr),
            "risk_by_priority": {
                p: round(r, 4) for p, r in sorted(risk_by_prio.items())
            },
            "tpot_ewma_s": {
                t.rid: round(t.tpot_ewma_s, 6)
                for t in self._reqs.values() if t.tpot_ewma_s is not None
            },
            "backpressure_floor": self.backpressure_floor(),
        }
        return self.last_summary

    # ---------------------------------------------------------------- #
    def at_risk_rids(self) -> List[Any]:
        return [t.rid for t in self._reqs.values() if t.at_risk or t.violated]

    def backpressure_floor(self) -> Optional[int]:
        """The admission floor: the highest priority among at-risk
        requests, or None when the at-risk set is empty (or this
        monitor was built with ``backpressure=False``).  The scheduler
        defers admitting work *below* the floor."""
        if not self.backpressure:
            return None
        prios = [
            t.priority for t in self._reqs.values()
            if t.at_risk or t.violated
        ]
        return max(prios) if prios else None

    def render(self) -> str:
        """One-line health summary the cluster can print per tick."""
        s = self.last_summary
        if not s:
            return "health: no ticks yet"
        risks = ", ".join(
            f"p{p}={r:.2f}" for p, r in s["risk_by_priority"].items()
        ) or "-"
        floor = s["backpressure_floor"]
        return (
            f"health@tick {s['tick']}: tracked={s['tracked']} "
            f"at_risk={len(s['at_risk'])} violated={len(s['violated'])} "
            f"risk[{risks}]"
            + (f" backpressure<p{floor}" if floor is not None else "")
        )
