"""Transport cost model of the port: the host half of ``repro.core.sched``.

Per-engine (α latency, β wire, γ epilogue) constants and the point-to-
point segmentation arithmetic that the serving layers price swaps with.
The planner that dispatches collectives over the GAS layer is not ported
yet; these plans are pure host arithmetic and describe themselves exactly
as the reference's do for the same inputs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

from repro_torch.obs import trace as obs_trace

__all__ = [
    "EngineCost",
    "CollectivePlan",
    "DEFAULT_COSTS",
    "cost_of",
    "plan_p2p",
]


@dataclasses.dataclass(frozen=True)
class EngineCost:
    """Per-engine transport constants (microseconds).

    alpha_us          — per-hop initiation latency.
    beta_us_per_kib   — wire time per KiB on one hop.
    gamma_us_per_kib  — receiver-side epilogue per KiB (slice/accumulate/
                        store); this is what segmentation overlaps with
                        the wire.
    """

    alpha_us: float
    beta_us_per_kib: float
    gamma_us_per_kib: float

    def hop_us(self, nbytes: float) -> float:
        kib = nbytes / 1024.0
        return self.alpha_us + (self.beta_us_per_kib + self.gamma_us_per_kib) * kib


# The reference's defaults, copied verbatim so that swap-vs-recompute
# decisions match it: they are NOT measurements of an H100 or of this
# port's transfers.
DEFAULT_COSTS: Dict[str, EngineCost] = {
    "xla": EngineCost(alpha_us=40.0, beta_us_per_kib=0.5, gamma_us_per_kib=0.2),
    "gascore": EngineCost(alpha_us=25.0, beta_us_per_kib=0.5, gamma_us_per_kib=0.2),
}

SEGMENT_TARGET_BYTES = 256 * 1024
MAX_SEGMENTS = 16
DEFAULT_DEPTH = 2  # double-buffered command FIFO


def cost_of(
    engine: Optional[Any] = None,
    costs: Optional[Dict[str, EngineCost]] = None,
) -> EngineCost:
    """Planning constants for an engine (anything with a ``name``); the
    software engine's when there is none.  Heterogeneous engine maps wait
    for the port's GAS layer."""
    table = costs or DEFAULT_COSTS
    fallback = table.get("xla") or next(iter(table.values()))
    if engine is None:
        return fallback
    return table.get(engine.name, fallback)


@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """One planned transfer: what to run and why."""

    op: str
    algorithm: str
    n_segments: int
    depth: int
    payload_bytes: int
    n_nodes: int
    engine: str
    est_us: float
    reason: str

    def describe(self) -> str:
        seg = (
            f", {self.n_segments} segment(s) x depth {self.depth}"
            if self.algorithm == "ring"
            else ""
        )
        return (
            f"{self.op}[{self.payload_bytes}B, n={self.n_nodes}, "
            f"{self.engine}] -> {self.algorithm}{seg} "
            f"(~{self.est_us:.0f}us: {self.reason})"
        )


def _segments_for(per_hop_bytes: float, cost: EngineCost) -> int:
    """Segment count: target SEGMENT_TARGET_BYTES per segment hop, but
    never let added per-segment α exceed the epilogue time it buys back."""
    if per_hop_bytes <= SEGMENT_TARGET_BYTES:
        return 1
    g = min(MAX_SEGMENTS, int(math.ceil(per_hop_bytes / SEGMENT_TARGET_BYTES)))
    kib = per_hop_bytes / 1024.0
    gain = min(cost.beta_us_per_kib, cost.gamma_us_per_kib) * kib
    while g > 1 and (g - 1) * cost.alpha_us > gain:
        g -= 1
    return max(1, g)


def _ring_est(
    per_hop_bytes: float, cost: EngineCost, hops: int, g: int, depth: int
) -> float:
    if g <= 1 or depth <= 1:
        return hops * cost.hop_us(per_hop_bytes)
    kib = per_hop_bytes / 1024.0
    return hops * (
        g * cost.alpha_us
        + max(cost.beta_us_per_kib, cost.gamma_us_per_kib) * kib
        + min(cost.beta_us_per_kib, cost.gamma_us_per_kib) * kib / g
    )


def _record_plan(plan: CollectivePlan) -> CollectivePlan:
    tr = obs_trace.active()
    if tr.enabled:
        tr.instant(
            "plan", cat="plan", op=plan.op, algorithm=plan.algorithm,
            n_segments=plan.n_segments, depth=plan.depth,
            bytes=plan.payload_bytes, n_nodes=plan.n_nodes,
            engine=plan.engine, est_us=round(plan.est_us, 3),
        )
    return plan


def plan_p2p(
    *,
    nbytes: int,
    engine: Optional[Any] = None,
    costs: Optional[Dict[str, EngineCost]] = None,
) -> CollectivePlan:
    """Plan one point-to-point put: how many segments to keep in flight so
    wire overlaps the receiver epilogue."""
    cost = cost_of(engine, costs)
    g = _segments_for(float(nbytes), cost)
    d = DEFAULT_DEPTH if g > 1 else 1
    est = _ring_est(float(nbytes), cost, 1, g, d)
    return _record_plan(CollectivePlan(
        "p2p", "ring", g, d, nbytes, 2,
        engine.name if engine is not None else "xla", est,
        "stage-boundary put" + (f"; segmented x{g}" if g > 1 else ""),
    ))
