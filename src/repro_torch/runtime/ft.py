"""Fault tolerance of the port: failure detection (``HeartbeatMonitor``).

Counterpart of ``repro.runtime.ft``, detection half: a timeout-based
detector over explicit heartbeats with an injectable clock, so the
policy is testable on the CPU and runs unchanged in the disaggregated
cluster, whose tick clock beats it (``repro_torch.serving.disagg``).
``StragglerTracker`` and ``elastic_plan`` are not ported yet.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

__all__ = ["HeartbeatMonitor"]


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
