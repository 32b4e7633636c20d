"""SLO-aware preemptive admission scheduling over the paged KV pool.

PR 4's pool rejected work it could not place: ``plan_admit`` booked a full
page table up front, so the pool could never oversubscribe and a burst
larger than physical memory simply waited.  With lazy allocation
(:func:`repro_torch.serving.pool.PagedKVStore.plan_admit` ``lazy=True``) the
pool *does* oversubscribe — aggregate logical demand may exceed physical
pages — and something must arbitrate when the free list runs dry.  This
module is that arbiter:

- **Admission** is a priority queue with deadlines: each request carries
  an :class:`SLO` (priority, TTFT deadline, TPOT deadline) and admission
  order is priority-major, earliest-deadline-first within a priority.
  Preempted requests outrank new admissions of the same priority
  (resume-first), so a victim is never starved by a stream of fresh
  arrivals it keeps paying for.
- **Preemption** picks victims when free pages run out: lowest priority
  first, most-recently-admitted within a priority (least progress lost),
  and never a victim whose priority exceeds the beneficiary's — a
  preemption chain therefore strictly descends and cannot cycle.  Victim
  *value* is refcount-aware: the freeable-page count the caller supplies
  should count only pages whose last reference the victim holds
  (prefix-shared physical pages stay resident for their sharers and are
  never invalidated — see ``PagedKVStore.evict_request``).
- **Swap vs recompute** is priced per victim with the measured
  :class:`~repro_torch.core.sched.EngineCost` β model (``BENCH_gas.json``):
  swapping costs two vectored transfers of the victim's resident bytes
  (out now, in at resume); recomputing costs one prefill plus replaying
  every generated token through the decode step.  Short-lived requests
  with few generated tokens recompute; page-heavy long decodes swap.

The scheduler is pure host-side bookkeeping over opaque request ids —
the colocated :class:`~repro_torch.launch.serve.PagedServer`, the
disaggregated cluster, and the hypothesis property tests all drive the
same object.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import sched
from repro_torch.obs.metrics import Registry, counter_property

__all__ = [
    "SLO",
    "swap_or_recompute",
    "AdmissionScheduler",
]


@dataclasses.dataclass(frozen=True)
class SLO:
    """Service-level objective of one request.

    ``priority`` is strict (higher preempts lower); the deadlines are
    *soft* ordering signals — TTFT orders admission within a priority,
    TPOT breaks ties among preemption victims (the request with the most
    deadline slack is evicted first)."""

    priority: int = 0
    ttft_deadline_s: float = math.inf
    tpot_deadline_s: float = math.inf


def swap_or_recompute(
    n_pages: int,
    page_bytes: int,
    generated_tokens: int,
    cost: sched.EngineCost,
    *,
    decode_step_us: float = 2000.0,
    prefill_us: float = 4000.0,
) -> Tuple[str, float, float]:
    """Price the two ways to preempt one victim and pick the cheaper.

    Swap = one vectored put now + one vectored get at resume, both
    carrying the victim's resident pages (α + β·KiB each way, the
    measured transport constants).  Recompute = drop the pages, then at
    resume one prefill plus one decode step per already-generated token
    (the replay that rebuilds the cache bit-identically).  Returns
    ``(mode, swap_us, recompute_us)``.
    """
    kib = n_pages * page_bytes / 1024.0
    swap_us = 2.0 * (cost.alpha_us + cost.beta_us_per_kib * kib)
    recompute_us = prefill_us + generated_tokens * decode_step_us
    mode = "swap" if swap_us <= recompute_us else "recompute"
    return mode, swap_us, recompute_us


@dataclasses.dataclass
class _Entry:
    rid: int
    slo: SLO
    t_submit: float
    prompt_len: int
    state: str = "queued"  # queued | running | preempted | done
    generated: int = 0
    t_admitted: float = 0.0
    admit_seq: int = 0
    preempt_mode: Optional[str] = None
    preempts: int = 0


class AdmissionScheduler:
    """The host-side arbiter (see module docstring).

    ``cost`` defaults to the software-node constants; pass
    ``sched.load_costs("BENCH_gas.json")[engine]`` (or any
    :class:`~repro_torch.core.sched.EngineCost`) to plan against measured wire
    speed.  ``page_bytes`` prices swap transfers; ``decode_step_us`` /
    ``prefill_us`` price recompute replay.

    The cumulative counters (evictions/swaps/recomputes/resumes) live on
    a typed :class:`~repro_torch.obs.metrics.Registry` — pass ``registry`` to
    share the owning cluster's registry (one ``reset()`` clears the
    whole cluster's counters); stats keys are unchanged.
    """

    # cumulative counters, registry-backed (explicit Counter kind)
    evictions = counter_property("sched_evictions")
    swaps = counter_property("sched_swaps")
    recomputes = counter_property("sched_recomputes")
    resumes = counter_property("sched_resumes")
    deferrals = counter_property("sched_deferrals")

    def __init__(
        self,
        *,
        page_bytes: int,
        cost: Optional[sched.EngineCost] = None,
        costs: Optional[Dict[str, sched.EngineCost]] = None,
        engine_name: str = "xla",
        decode_step_us: float = 2000.0,
        prefill_us: float = 4000.0,
        registry: Optional[Registry] = None,
    ):
        table = costs or sched.DEFAULT_COSTS
        self.cost = cost or table.get(engine_name) or next(iter(table.values()))
        self.page_bytes = page_bytes
        self.decode_step_us = decode_step_us
        self.prefill_us = prefill_us
        self._entries: Dict[int, _Entry] = {}
        self._seq = 0
        self.metrics = registry if registry is not None else Registry()
        self.health = None  # Optional[repro.obs.health.HealthMonitor]
        self.evictions = 0
        self.swaps = 0
        self.recomputes = 0
        self.resumes = 0
        self.deferrals = 0

    # ------------------------------------------------------------------ #
    def submit(
        self,
        rid: int,
        slo: Optional[SLO] = None,
        prompt_len: int = 0,
        now: float = 0.0,
    ) -> None:
        if rid in self._entries:
            raise ValueError(f"request {rid} already submitted")
        self._entries[rid] = _Entry(
            rid=rid, slo=slo or SLO(), t_submit=now, prompt_len=prompt_len
        )

    def entry(self, rid: int) -> _Entry:
        return self._entries[rid]

    def slo(self, rid: int) -> SLO:
        return self._entries[rid].slo

    def _key(self, e: _Entry) -> Tuple:
        # priority-major; resume-first within a priority (anti-starvation:
        # a victim outranks every later same-priority arrival); then EDF
        # on the absolute TTFT deadline; then FIFO.
        return (
            -e.slo.priority,
            0 if e.state == "preempted" else 1,
            e.t_submit + e.slo.ttft_deadline_s,
            e.t_submit,
            e.rid,
        )

    def attach_health(self, monitor) -> None:
        """Wire a :class:`~repro.obs.health.HealthMonitor` in: while its
        at-risk set is non-empty, :meth:`admission_order` defers every
        waiting request *below* the monitor's backpressure floor (the
        highest at-risk priority) — deadline-critical work stops
        competing with bulk admissions for pool pages.  The floor clears
        the moment the at-risk set drains, so nothing starves."""
        self.health = monitor

    def admission_order(self) -> List[int]:
        """Waiting requests (queued + preempted) in admission order.

        With an attached health monitor signalling backpressure,
        below-floor requests are deferred (dropped from this tick's
        order, counted on ``sched_deferrals``)."""
        waiting = [
            e for e in self._entries.values()
            if e.state in ("queued", "preempted")
        ]
        floor = (
            self.health.backpressure_floor()
            if self.health is not None else None
        )
        if floor is not None:
            eligible = [e for e in waiting if e.slo.priority >= floor]
            self.deferrals += len(waiting) - len(eligible)
            waiting = eligible
        return [e.rid for e in sorted(waiting, key=self._key)]

    # ------------------------------------------------------------------ #
    def on_admitted(self, rid: int, now: float = 0.0) -> None:
        e = self._entries[rid]
        if e.state == "preempted":
            self.resumes += 1
        e.state = "running"
        e.t_admitted = now
        self._seq += 1
        e.admit_seq = self._seq

    def on_step(self, rid: int) -> None:
        self._entries[rid].generated += 1

    def on_done(self, rid: int) -> None:
        self._entries[rid].state = "done"

    def on_preempted(self, rid: int, mode: str) -> None:
        e = self._entries[rid]
        e.state = "preempted"
        e.preempt_mode = mode
        e.preempts += 1
        self.evictions += 1
        if mode == "swap":
            self.swaps += 1
        else:
            self.recomputes += 1

    # ------------------------------------------------------------------ #
    def choose_mode(self, rid: int, n_pages: int) -> Tuple[str, float, float]:
        """Swap vs recompute for one prospective victim (β-model priced)."""
        e = self._entries[rid]
        return swap_or_recompute(
            n_pages,
            self.page_bytes,
            e.generated,
            self.cost,
            decode_step_us=self.decode_step_us,
            prefill_us=self.prefill_us,
        )

    def pick_victims(
        self,
        running: Sequence[int],
        need_pages: int,
        freeable: Callable[[int], int],
        beneficiary: Optional[int] = None,
        strict: bool = False,
    ) -> List[int]:
        """Choose preemption victims freeing at least ``need_pages``.

        ``freeable(rid)`` must count only pages whose LAST reference the
        victim holds (refcount-aware: evicting a request never invalidates
        a physical page a running sharer still maps).  Victims are taken
        lowest-priority first, and never above the beneficiary's priority
        — so preemption strictly descends and cannot starve or cycle.
        ``strict=True`` additionally requires victims strictly BELOW the
        beneficiary (the admission-triggered rule: a fresh arrival never
        displaces an equal-priority running request; a running request
        that must write its next page may, since its victims resume from
        pages freed by retirement, not by counter-preemption).  Returns
        ``[]`` when the reachable victims cannot free enough.
        """
        if need_pages <= 0:
            return []
        cap = (
            self._entries[beneficiary].slo.priority
            if beneficiary is not None and beneficiary in self._entries
            else None
        )
        cands = []
        for rid in running:
            if rid == beneficiary:
                continue
            e = self._entries.get(rid)
            if e is None or e.state != "running":
                continue
            if cap is not None and (
                e.slo.priority > cap or (strict and e.slo.priority >= cap)
            ):
                continue
            cands.append(e)
        # lowest priority first; most slack, then most recently admitted
        # (least progress lost) within a priority
        cands.sort(
            key=lambda e: (
                e.slo.priority,
                -(e.t_admitted + e.slo.tpot_deadline_s),
                -e.admit_seq,
            )
        )
        victims: List[int] = []
        freed = 0
        for e in cands:
            gain = freeable(e.rid)
            if gain <= 0:
                continue
            victims.append(e.rid)
            freed += gain
            if freed >= need_pages:
                return victims
        return []

    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, Any]:
        return {
            "sched_evictions": self.evictions,
            "sched_swaps": self.swaps,
            "sched_recomputes": self.recomputes,
            "sched_resumes": self.resumes,
            "sched_deferrals": self.deferrals,
        }
