"""Collective scheduler: size-aware algorithm selection + segmentation.

Port of ``repro.core.sched``: the same cost model, planner and planned
execution, over the port's engines.  Plans are pure host arithmetic and
``describe()`` themselves exactly as the reference's do for the same
inputs.  The default constants are the reference's, copied verbatim so
that decisions match it: they are NOT measurements of an H100;
:func:`measure_costs` fits a device's own from timed puts.

The paper's GAScore earns its keep not just by moving bytes but by the
*schedule* it drains from its command FIFO: large transfers are cut into
segments so the wire time of segment k+1 overlaps the slice/accumulate
epilogue of segment k, and the collective algorithm itself is chosen by
message size (latency-bound payloads take log-depth trees, bandwidth-bound
payloads take segmented rings).  This module is that scheduler layer,
software-visible:

1. **Cost model** — per-engine (α latency, β wire, γ epilogue) constants,
   loadable from a ``BENCH_gas.json``-shaped artifact; heterogeneous
   :class:`~repro_torch.core.engine.EngineMap` jobs plan against the
   *worst* member engine (the ring is paced by its slowest edge).

2. **Planning** — :func:`plan_collective` turns (op, payload bytes, node
   count, engine) into a :class:`CollectivePlan`: the algorithm (ring vs
   recursive-doubling/tree vs direct exchange), the segment count and the
   pipeline depth, with an estimated cost and a human-readable reason.

3. **Execution** — :func:`all_reduce` / :func:`all_gather` /
   :func:`reduce_scatter` / :func:`broadcast` / :func:`all_to_all` plan
   and dispatch in one call (the AM router routes through these).

All execution paths must run inside ``Context.spmd``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Dict, Iterable, Optional

import torch

from repro_torch.core import collectives
from repro_torch.core.engine import CommEngine, EngineMap
from repro_torch.obs import trace as obs_trace

__all__ = [
    "EngineCost",
    "try_fit_from_trace",
    "CollectivePlan",
    "DEFAULT_COSTS",
    "load_costs",
    "measure_costs",
    "cost_of",
    "plan_collective",
    "plan_p2p",
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "broadcast",
    "all_to_all",
]


@dataclasses.dataclass(frozen=True)
class EngineCost:
    """Per-engine transport constants (microseconds).

    alpha_us          — per-hop initiation latency (the command-word issue:
                        ppermute setup for software nodes, DMA descriptor
                        push for the GAScore).
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

    def worst(self, other: "EngineCost") -> "EngineCost":
        return EngineCost(
            max(self.alpha_us, other.alpha_us),
            max(self.beta_us_per_kib, other.beta_us_per_kib),
            max(self.gamma_us_per_kib, other.gamma_us_per_kib),
        )

    @staticmethod
    def _points(spans: Iterable) -> list:
        """(KiB, measured us) pairs from recorded transfer spans — either
        :class:`repro_torch.obs.trace.Span` objects (``bytes`` tag + wall
        ``dur_us``) or plain ``{"bytes", "dur_us"}`` dicts."""
        pts = []
        for s in spans:
            if isinstance(s, dict):
                b, d = s.get("bytes"), s.get("dur_us")
            else:
                b, d = s.args.get("bytes"), s.dur_us
            if not b or not d or d <= 0:
                continue
            pts.append((b / 1024.0, float(d)))
        return pts

    @staticmethod
    def _line_fit(pts: list, what: str) -> tuple:
        """Least-squares ``(intercept, slope)`` over (KiB, us) points;
        raises :class:`ValueError` on thin data (fewer than two points,
        or a single payload size — the constants are not separable)."""
        if len(pts) < 2:
            raise ValueError(
                f"{what} needs >= 2 measured transfer spans with "
                f"byte tags, got {len(pts)}"
            )
        n = float(len(pts))
        sx = sum(x for x, _ in pts)
        sy = sum(y for _, y in pts)
        sxx = sum(x * x for x, _ in pts)
        sxy = sum(x * y for x, y in pts)
        den = n * sxx - sx * sx
        if den <= 0:
            raise ValueError(
                f"{what} needs spans of at least two distinct "
                f"sizes to separate the intercept from the slope"
            )
        slope = (n * sxy - sx * sy) / den
        intercept = (sy - slope * sx) / n
        return intercept, slope

    @classmethod
    def fit_gamma_from_trace(cls, spans: Iterable) -> float:
        """Fit γ (receiver-epilogue us/KiB) from *measured epilogue*
        spans — the install/accumulate program timed alone, at several
        payload sizes (``obs.profile`` records these).  End-to-end
        transfer walls cannot separate γ from β (the epilogue overlaps
        the wire by design); a directly timed epilogue can: its per-KiB
        slope IS γ.  The per-call dispatch overhead lands in the
        intercept and is discarded."""
        pts = cls._points(spans)
        _, slope = cls._line_fit(pts, "fit_gamma_from_trace")
        return max(slope, 0.0)

    @classmethod
    def fit_from_trace(
        cls, spans: Iterable, *, gamma_us_per_kib: float = 0.0,
        epilogue_spans: Optional[Iterable] = None,
    ) -> "EngineCost":
        """Refit the model by least squares from *measured* transfer
        spans — the loop the paper's hardware counters close in ACCL+:
        plan with a model, measure what the transfers actually cost in
        situ, feed the measurements back.

        ``spans`` must cover at least two distinct sizes (α and β are
        not separable from a single point).  Without ``epilogue_spans``,
        γ is not observable from end-to-end transfer walls (it overlaps
        the wire by design) and passes through unchanged.  With
        ``epilogue_spans`` (the receiver install program timed alone —
        see :meth:`fit_gamma_from_trace`), the measured per-KiB slope of
        the end-to-end walls is *decomposed*: the epilogue's measured
        share becomes γ and the remainder stays β, so ``hop_us`` (and
        therefore :meth:`model_error`) is unchanged while segmentation
        planning gains a measured overlap opportunity (``min(β, γ)``).
        """
        pts = cls._points(spans)
        alpha, beta = cls._line_fit(pts, "fit_from_trace")
        alpha, beta = max(alpha, 0.0), max(beta, 0.0)
        gamma = gamma_us_per_kib
        if epilogue_spans is not None:
            measured = cls.fit_gamma_from_trace(epilogue_spans)
            # the epilogue cannot claim more than the measured end-to-end
            # per-KiB cost; the un-overlapped remainder is the wire
            gamma = min(measured, beta)
            beta = beta - gamma
        return cls(alpha, beta, gamma)

    def model_error(self, spans: Iterable) -> float:
        """Mean absolute relative error of this model's :meth:`hop_us`
        prediction against measured transfer spans (0.0 = perfect)."""
        pts = self._points(spans)
        if not pts:
            raise ValueError("model_error needs measured transfer spans")
        return sum(
            abs(self.hop_us(kib * 1024.0) - d) / d for kib, d in pts
        ) / len(pts)


def try_fit_from_trace(
    spans: Iterable,
    *,
    epilogue_spans: Optional[Iterable] = None,
    default: Optional[EngineCost] = None,
) -> tuple:
    """:meth:`EngineCost.fit_from_trace` that reports instead of dying.

    A thin trace (cold ring, filtered spans, a bench section that ran
    alone) raises :class:`ValueError` from the fitter; consumers that
    refit mid-run — the bench's obs section, anything folding measured
    spans back against :func:`_record_plan` estimates — should degrade
    to their prior model, not crash the run.  Returns ``(cost, note)``:
    ``note`` is ``"fit: ok"`` on success, else
    ``"fit: insufficient-data (<reason>)"`` with ``cost`` falling back
    to ``default`` (possibly None).
    """
    try:
        fit = EngineCost.fit_from_trace(spans, epilogue_spans=epilogue_spans)
        return fit, "fit: ok"
    except ValueError as e:
        return default, f"fit: insufficient-data ({e})"


# The reference's defaults, copied verbatim so that plans match it (they
# are NOT measurements of an H100 or of this port's transfers).  With
# these, recursive doubling wins all-reduce below ~0.5 MiB on 8 nodes and
# the segmented ring takes over above it.
DEFAULT_COSTS: Dict[str, EngineCost] = {
    "xla": EngineCost(alpha_us=40.0, beta_us_per_kib=0.5, gamma_us_per_kib=0.2),
    "gascore": EngineCost(alpha_us=25.0, beta_us_per_kib=0.5, gamma_us_per_kib=0.2),
}

# Segmentation targets: chunk the per-hop payload so one segment's wire
# time is a few α (enough to hide the epilogue without drowning in
# initiation overhead), and bound the segment count.
SEGMENT_TARGET_BYTES = 256 * 1024
MAX_SEGMENTS = 16
DEFAULT_DEPTH = 2  # double-buffered command FIFO


def load_costs(path: str) -> Dict[str, EngineCost]:
    """Read per-engine constants from a ``BENCH_gas.json`` artifact
    (``engine_costs`` key); unknown engines fall back to defaults.

    When the artifact also carries measured *pair* costs (an
    ``engine_pair_costs`` key with ``"a->b"`` entries — the edge cost of
    a heterogeneous hop, e.g. an xla rank pushing into a gascore rank's
    FIFO), those land in the same table under their ``"a->b"`` keys and
    :func:`cost_of` prefers them for mixed :class:`~repro_torch.core.engine.
    EngineMap` groups.  Pair entries are strictly optional: a missing or
    partial table degrades to the analytic worst-member α/β model, never
    to a lookup error.
    """
    costs = dict(DEFAULT_COSTS)
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return costs
    for section in ("engine_costs", "engine_pair_costs"):
        for name, c in (data.get(section) or {}).items():
            try:
                costs[name] = EngineCost(
                    float(c["alpha_us"]),
                    float(c["beta_us_per_kib"]),
                    float(c.get("gamma_us_per_kib", 0.05)),
                )
            except (KeyError, TypeError, ValueError):
                continue
    return costs


# per-rank payloads the transport is timed at by :func:`measure_costs`
MEASURE_BYTES = (1 << 10, 1 << 20, 1 << 24, 1 << 26)
_MEASURED: Dict[tuple, Dict[str, EngineCost]] = {}


def _timed_us(fn, device: torch.device, reps: int) -> float:
    """Median wall microseconds of one call of ``fn`` as a program sees
    it, its device work included (the device drained before the call and
    after it), after one warm call.  A wall and not the device's time
    alone: a program's cost is mostly its dispatch on the host (the vmap
    over ranks, each transport op's enqueue), which no device timer sees;
    its moves wait on the host for nothing (their index lists are cached
    on the device)."""
    def drain():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    times = []
    for _ in range(reps):
        drain()
        t0 = time.perf_counter()
        fn()
        drain()
        times.append(1e6 * (time.perf_counter() - t0))
    return float(sorted(times)[len(times) // 2])


def measure_costs(
    device: Any,
    backends: Iterable[str] = ("xla", "gascore"),
    *,
    sizes: Iterable[int] = MEASURE_BYTES,
    reps: int = 9,
) -> Dict[str, EngineCost]:
    """This device's transport constants: the cost table (the defaults,
    with each of ``backends`` replaced by its measurement) that plans and
    prices transfers where the reference's constants, a TPU's, do not
    hold.

    Each engine moves ``sizes`` bytes per rank between two ranks of a
    :class:`~repro_torch.core.gasnet.Context` on ``device`` (one
    ``permute``) and the receiver lands them in place
    (:func:`~repro_torch.core.extended.land`); the landing is also timed
    alone.  :func:`try_fit_from_trace` fits α and β from the end-to-end
    times and splits γ off β from the landing's (its per-KiB slope); an
    engine whose points do not fit keeps its default.  Measured once per
    device, engines and sizes."""
    from repro_torch.core import extended, gasnet

    device = torch.device(device)
    backends = tuple(sorted(set(backends)))
    sizes = tuple(sizes)
    key = (str(device), backends, sizes, reps)
    if key not in _MEASURED:
        costs = dict(DEFAULT_COSTS)
        for backend in backends:
            ctx = gasnet.Context(2, backend=backend, device=device)

            def move(node, x):
                return node.engine.permute(x, [1, 0])

            spans, epilogue = [], []
            for nbytes in sizes:
                n_el = max(nbytes // 4, 1)
                x = torch.arange(2 * n_el, dtype=torch.float32,
                                 device=device).reshape(2, 1, n_el)
                seg = torch.zeros((2, n_el), dtype=torch.float32, device=device)
                offsets = torch.zeros((2, 1), dtype=torch.int32, device=device)
                flags = torch.ones((2, 1), dtype=torch.bool, device=device)
                put = lambda: extended.land(  # noqa: E731
                    seg, ctx.spmd(move, x).reshape(2, 1, n_el), offsets, flags)
                install = lambda: extended.land(  # noqa: E731
                    seg, x, offsets, flags)
                spans.append({"bytes": 4 * n_el,
                              "dur_us": _timed_us(put, device, reps)})
                epilogue.append({"bytes": 4 * n_el,
                                 "dur_us": _timed_us(install, device, reps)})
            costs[backend], _ = try_fit_from_trace(
                spans, epilogue_spans=epilogue, default=DEFAULT_COSTS[backend])
        _MEASURED[key] = costs
    return dict(_MEASURED[key])


def cost_of(
    engine: Optional[CommEngine],
    costs: Optional[Dict[str, EngineCost]] = None,
) -> EngineCost:
    """Planning constants for an engine; a heterogeneous map plans against
    the worst member (the ring is paced by its slowest edge).

    If the cost table carries measured pair entries (``"a->b"`` keys from
    ``load_costs``), a mixed map plans against the worst measured *edge*
    between its member backends instead of the analytic per-engine worst.
    Missing pair entries fall back to the analytic model via ``.get`` —
    never a KeyError, so a partially-measured ``BENCH_gas.json`` still
    plans every group.
    """
    table = costs or DEFAULT_COSTS
    fallback = table.get("xla") or next(iter(table.values()))
    if engine is None:
        return fallback
    if isinstance(engine, EngineMap):
        members = sorted(set(engine.backends))
        acc = None
        for b in members:
            c = table.get(b, fallback)
            acc = c if acc is None else acc.worst(c)
        analytic = acc or fallback
        if len(members) > 1:
            pairs = [
                table.get(f"{a}->{b}")
                for a in members
                for b in members
                if a != b
            ]
            measured = [p for p in pairs if p is not None]
            if measured and len(measured) == len(pairs):
                worst = measured[0]
                for p in measured[1:]:
                    worst = worst.worst(p)
                return worst
        return analytic
    return table.get(engine.name, fallback)


@dataclasses.dataclass(frozen=True)
class CollectivePlan:
    """One planned collective: what to run and why.

    ``algorithm`` ∈ {"ring", "recursive_doubling", "tree", "direct",
    "native"}; ``n_segments``/``depth`` only apply to ring plans.
    """

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
    """Segment count for a ring: target SEGMENT_TARGET_BYTES per segment
    hop, but never let added per-segment α exceed the epilogue time it
    buys back."""
    if per_hop_bytes <= SEGMENT_TARGET_BYTES:
        return 1
    g = min(MAX_SEGMENTS, int(math.ceil(per_hop_bytes / SEGMENT_TARGET_BYTES)))
    # overlap buys ~min(beta, gamma) * per_hop_kib; alpha costs (g-1)*alpha
    kib = per_hop_bytes / 1024.0
    gain = min(cost.beta_us_per_kib, cost.gamma_us_per_kib) * kib
    while g > 1 and (g - 1) * cost.alpha_us > gain:
        g -= 1
    return max(1, g)


def _ring_est(
    per_hop_bytes: float, cost: EngineCost, hops: int, g: int, depth: int
) -> float:
    """Pipelined ring estimate: per hop, G segment commands (α each) plus
    wire/epilogue overlapped across segments when depth > 1."""
    if g <= 1 or depth <= 1:
        return hops * cost.hop_us(per_hop_bytes)
    kib = per_hop_bytes / 1024.0
    return hops * (
        g * cost.alpha_us
        + max(cost.beta_us_per_kib, cost.gamma_us_per_kib) * kib
        + min(cost.beta_us_per_kib, cost.gamma_us_per_kib) * kib / g
    )


def _record_plan(plan: CollectivePlan) -> CollectivePlan:
    """Emit the chosen algorithm + *predicted* cost as a trace instant,
    so a measured transfer span sits next to the estimate that planned
    it — the cost-model error becomes a trace query."""
    tr = obs_trace.active()
    if tr.enabled:
        tr.instant(
            "plan", cat="plan", op=plan.op, algorithm=plan.algorithm,
            n_segments=plan.n_segments, depth=plan.depth,
            bytes=plan.payload_bytes, n_nodes=plan.n_nodes,
            engine=plan.engine, est_us=round(plan.est_us, 3),
        )
    return plan


def plan_collective(
    op: str,
    *,
    nbytes: int,
    n_nodes: int,
    engine: Optional[CommEngine] = None,
    costs: Optional[Dict[str, EngineCost]] = None,
    n_segments: Optional[int] = None,
    depth: Optional[int] = None,
) -> CollectivePlan:
    """Choose algorithm + segmentation for one collective.

    ``engine`` supplies the cost constants and capability flags (falls
    back to software-node defaults when None).  Explicit ``n_segments`` /
    ``depth`` pin the segmentation — and therefore the ring algorithm
    itself: a caller asking for segments is asking for the segmented
    ring, so the latency-tier overrides (recursive doubling, tree) are
    skipped.
    """
    return _record_plan(_plan_collective(
        op, nbytes=nbytes, n_nodes=n_nodes, engine=engine, costs=costs,
        n_segments=n_segments, depth=depth,
    ))


def _plan_collective(
    op: str,
    *,
    nbytes: int,
    n_nodes: int,
    engine: Optional[CommEngine] = None,
    costs: Optional[Dict[str, EngineCost]] = None,
    n_segments: Optional[int] = None,
    depth: Optional[int] = None,
) -> CollectivePlan:
    cost = cost_of(engine, costs)
    ename = engine.name if engine is not None else "xla"
    n = max(1, n_nodes)
    pow2 = n & (n - 1) == 0
    partial_ok = engine.can_permute_partial if engine is not None else True
    pinned = n_segments is not None or depth is not None
    kib = nbytes / 1024.0

    def ring_plan(hops: int, per_hop_bytes: float, chunk_desc: str) -> CollectivePlan:
        g = n_segments if n_segments is not None else _segments_for(
            per_hop_bytes, cost
        )
        d = depth if depth is not None else (DEFAULT_DEPTH if g > 1 else 1)
        est = _ring_est(per_hop_bytes, cost, hops, g, d)
        why = f"bandwidth-bound: ring moves {chunk_desc} per hop" + (
            f"; segmented x{g} to overlap wire with epilogue" if g > 1 else ""
        )
        return CollectivePlan(op, "ring", g, d, nbytes, n, ename, est, why)

    if n == 1:
        return CollectivePlan(
            op, "ring", 1, 1, nbytes, n, ename, 0.0, "single node: no wire"
        )

    if op == "all_reduce":
        # input is the full (n*m) buffer; each RS/AG hop carries one S/n chunk
        ring = ring_plan(2 * (n - 1), nbytes / n, "S/n")
        if pow2 and not pinned:
            rd_est = math.log2(n) * cost.hop_us(nbytes)
            if rd_est < ring.est_us:
                return CollectivePlan(
                    op, "recursive_doubling", 1, 1, nbytes, n, ename, rd_est,
                    "latency-bound: log2(n) exchange rounds beat 2(n-1) hops",
                )
        return ring

    if op == "all_gather":
        # nbytes is the LOCAL contribution; every hop forwards one full
        # local-sized chunk, so per-hop bytes = nbytes (not nbytes/n)
        return ring_plan(n - 1, float(nbytes), "the local chunk")

    if op == "reduce_scatter":
        # input is the full (n*m) buffer; each hop carries one S/n packet
        return ring_plan(n - 1, nbytes / n, "S/n")

    if op == "broadcast":
        # the ring broadcast forwards the FULL payload on each of its n-1
        # hops (no chunking), unlike the ring reductions' S/n chunks
        ring_est = (n - 1) * (cost.alpha_us + cost.beta_us_per_kib * kib)
        ring = CollectivePlan(
            op, "ring", 1, 1, nbytes, n, ename, ring_est,
            "ring pipeline: n-1 forward hops (bijection-only transport)",
        )
        if partial_ok and not pinned:
            tree_est = math.ceil(math.log2(n)) * (
                cost.alpha_us + cost.beta_us_per_kib * kib
            )
            if tree_est < ring.est_us:
                return CollectivePlan(
                    op, "tree", 1, 1, nbytes, n, ename, tree_est,
                    "binomial tree: ceil(log2 n) rounds beat n-1 hops",
                )
        return ring

    if op == "all_to_all":
        native = (
            engine is not None
            and type(engine).all_to_all is not CommEngine.all_to_all
        )
        est = cost.alpha_us + cost.beta_us_per_kib * kib * (n - 1) / n
        if native:
            return CollectivePlan(
                op, "native", 1, 1, nbytes, n, ename, est,
                "engine-native all-to-all (XLA transport)",
            )
        return CollectivePlan(
            op, "direct", 1, 1, nbytes, n, ename, est,
            "fully overlapped personalized exchange: all n-1 puts in flight",
        )

    raise ValueError(f"unknown collective op {op!r}")


def plan_p2p(
    *,
    nbytes: int,
    engine: Optional[CommEngine] = None,
    costs: Optional[Dict[str, EngineCost]] = None,
) -> CollectivePlan:
    """Plan one point-to-point put (a gpipe stage boundary): how many
    segments to keep in flight so wire overlaps the receiver epilogue."""
    cost = cost_of(engine, costs)
    g = _segments_for(float(nbytes), cost)
    d = DEFAULT_DEPTH if g > 1 else 1
    est = _ring_est(float(nbytes), cost, 1, g, d)
    return _record_plan(CollectivePlan(
        "p2p", "ring", g, d, nbytes, 2,
        engine.name if engine is not None else "xla", est,
        "stage-boundary put" + (f"; segmented x{g}" if g > 1 else ""),
    ))


# --------------------------------------------------------------------------- #
# Plan-driven execution: the one entry point call sites migrate to
# --------------------------------------------------------------------------- #
def _nbytes(x: torch.Tensor) -> int:
    return int(x.numel()) * x.element_size()


def _resolve(
    op: str, engine: CommEngine, x: torch.Tensor, plan: Optional[CollectivePlan],
    costs: Optional[Dict[str, EngineCost]],
) -> CollectivePlan:
    if plan is not None:
        return plan
    return plan_collective(
        op, nbytes=_nbytes(x), n_nodes=engine.n_nodes, engine=engine,
        costs=costs,
    )


def all_reduce(
    engine: CommEngine,
    x: torch.Tensor,
    *,
    plan: Optional[CollectivePlan] = None,
    costs: Optional[Dict[str, EngineCost]] = None,
) -> torch.Tensor:
    """Planned all-reduce: recursive doubling for latency-bound payloads,
    segmented ring for bandwidth-bound ones."""
    p = _resolve("all_reduce", engine, x, plan, costs)
    if p.algorithm == "recursive_doubling":
        return collectives.recursive_doubling_all_reduce(engine, x)
    return collectives.segmented_ring_all_reduce(
        engine, x, n_segments=p.n_segments, depth=p.depth
    )


def all_gather(
    engine: CommEngine,
    x: torch.Tensor,
    *,
    plan: Optional[CollectivePlan] = None,
    costs: Optional[Dict[str, EngineCost]] = None,
) -> torch.Tensor:
    p = _resolve("all_gather", engine, x, plan, costs)
    return collectives.segmented_ring_all_gather(
        engine, x, n_segments=p.n_segments, depth=p.depth
    )


def reduce_scatter(
    engine: CommEngine,
    x: torch.Tensor,
    *,
    plan: Optional[CollectivePlan] = None,
    costs: Optional[Dict[str, EngineCost]] = None,
) -> torch.Tensor:
    p = _resolve("reduce_scatter", engine, x, plan, costs)
    return collectives.segmented_ring_reduce_scatter(
        engine, x, n_segments=p.n_segments, depth=p.depth
    )


def broadcast(
    engine: CommEngine,
    x: torch.Tensor,
    *,
    root: int = 0,
    plan: Optional[CollectivePlan] = None,
    costs: Optional[Dict[str, EngineCost]] = None,
) -> torch.Tensor:
    p = _resolve("broadcast", engine, x, plan, costs)
    if p.algorithm == "tree":
        return collectives.tree_broadcast(engine, x, root=root)
    return collectives.broadcast(engine, x, root=root)


def all_to_all(
    engine: CommEngine,
    x: torch.Tensor,
    *,
    plan: Optional[CollectivePlan] = None,
    costs: Optional[Dict[str, EngineCost]] = None,
) -> torch.Tensor:
    p = _resolve("all_to_all", engine, x, plan, costs)
    if p.algorithm == "native":
        return engine.all_to_all(x)
    return collectives.exchange(engine, x)
