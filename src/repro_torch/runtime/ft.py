"""Fault tolerance of the port: failure detection, stragglers, elastic plans.

Counterpart of ``repro.runtime.ft``: hardware-independent control-plane
logic with injectable clocks and failure sources, so each policy is
testable on the CPU and runs unchanged in the disaggregated cluster,
whose tick clock beats the detector (``repro_torch.serving.disagg``).

- :class:`HeartbeatMonitor` -- per-node liveness with timeout-based
  failure detection.
- :class:`StragglerTracker` -- per-node step-time EWMA; flags nodes
  slower than ``threshold x`` the fleet median, and quarantines one that
  stays slow for ``patience`` assessments.
- :func:`elastic_plan` -- given survivors and a required model-parallel
  width, the largest usable (pod, data, model) mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "HeartbeatMonitor",
    "StragglerTracker",
    "StragglerDecision",
    "elastic_plan",
]


class HeartbeatMonitor:
    """Timeout-based failure detector over explicit heartbeats."""

    def __init__(
        self,
        node_ids: Sequence[int],
        timeout_s: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.timeout_s = timeout_s
        self.clock = clock
        now = clock()
        self.last_seen: Dict[int, float] = {n: now for n in node_ids}
        self._failed: set = set()

    def beat(self, node_id: int, at: Optional[float] = None) -> None:
        if node_id in self._failed:
            return  # a failed node must rejoin via admit()
        self.last_seen[node_id] = self.clock() if at is None else at

    def admit(self, node_id: int) -> None:
        self._failed.discard(node_id)
        self.last_seen[node_id] = self.clock()

    def check(self) -> List[int]:
        """Returns newly failed nodes (monotone: stays failed until admit)."""
        now = self.clock()
        newly = [
            n
            for n, t in self.last_seen.items()
            if n not in self._failed and now - t > self.timeout_s
        ]
        self._failed.update(newly)
        return newly

    @property
    def failed(self) -> List[int]:
        return sorted(self._failed)

    @property
    def alive(self) -> List[int]:
        return sorted(set(self.last_seen) - self._failed)


@dataclasses.dataclass(frozen=True)
class StragglerDecision:
    node_id: int
    action: str  # "observe" | "quarantine"
    ratio: float  # node EWMA / fleet median


class StragglerTracker:
    """EWMA step-time tracking with median-relative straggler flagging."""

    def __init__(
        self,
        node_ids: Sequence[int],
        alpha: float = 0.3,
        threshold: float = 1.8,
        patience: int = 3,
    ):
        self.alpha = alpha
        self.threshold = threshold
        self.patience = patience
        self.ewma: Dict[int, Optional[float]] = {n: None for n in node_ids}
        self.strikes: Dict[int, int] = {n: 0 for n in node_ids}

    def record(self, node_id: int, step_time_s: float) -> None:
        prev = self.ewma[node_id]
        self.ewma[node_id] = (
            step_time_s
            if prev is None
            else self.alpha * step_time_s + (1 - self.alpha) * prev
        )

    def _median(self) -> Optional[float]:
        vals = sorted(v for v in self.ewma.values() if v is not None)
        if not vals:
            return None
        return vals[len(vals) // 2]

    def assess(self) -> List[StragglerDecision]:
        med = self._median()
        if med is None or med <= 0:
            return []
        out = []
        for n, v in self.ewma.items():
            if v is None:
                continue
            ratio = v / med
            if ratio > self.threshold:
                self.strikes[n] += 1
                action = (
                    "quarantine" if self.strikes[n] >= self.patience else "observe"
                )
                out.append(StragglerDecision(n, action, ratio))
            else:
                self.strikes[n] = 0
        return out

    def drop(self, node_id: int) -> None:
        self.ewma.pop(node_id, None)
        self.strikes.pop(node_id, None)


def elastic_plan(
    n_alive: int, model_width: int, prefer_pods: int = 1
) -> Optional[Tuple[int, int, int]]:
    """Largest (pod, data, model) mesh using <= n_alive nodes.

    ``model_width`` is fixed by the parallelism plan (TP degree must match
    the checkpointed layout for cheap resharding; changing it is a restore-
    time re-shard, which the checkpoint format also supports).  Data-
    parallel width shrinks to the largest fit; pods collapse before DP.
    """
    if model_width <= 0 or n_alive < model_width:
        return None
    best = None
    best_used = -1
    for pods in range(prefer_pods, 0, -1):
        per_pod = n_alive // pods
        dp = per_pod // model_width
        used = pods * dp * model_width
        if dp >= 1 and used > best_used:
            best, best_used = (pods, dp, model_width), used
    return best
