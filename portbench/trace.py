"""Spans the benchmark records around its calls into the program, and the
reduction of a profiler trace of the card to what the per-layer metrics
read.

The device's clock and the host's are tied by a marker: the traced
window starts with a synchronised card and one tiny operation, whose
device start is taken as the host time at which it was launched.
"""

from __future__ import annotations

import contextlib
import json
import re
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Sequence, Tuple

ROOT = Path(__file__).resolve().parent


class Spans:
    """Host intervals ``(label, t0, t1)`` on ``time.perf_counter``."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, label: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((label, t0, time.perf_counter()))

    def label_at(self, t: float, default: str) -> str:
        for label, t0, t1 in self.items:
            if t0 <= t <= t1:
                return label
        return default


class Categories:
    """Kernel-name patterns to categories, from every ``kernels/*.json``:
    the program's own kernels first, then the rest, each file's patterns
    in its order; a name no pattern takes is ``other``."""

    def __init__(self, folder: Path = ROOT / "kernels"):
        own, rest = [], []
        self.own: set = set()
        for f in sorted(folder.glob("*.json")):
            spec = json.loads(f.read_text())
            pats = [(cat, re.compile(p, re.IGNORECASE))
                    for cat, ps in spec["patterns"].items() for p in ps]
            (own if spec.get("own") else rest).extend(pats)
            if spec.get("own"):
                self.own.update(spec["patterns"])
        self.patterns = own + rest
        self._memo: Dict[str, str] = {}

    def of(self, name: str) -> str:
        cat = self._memo.get(name)
        if cat is None:
            cat = next((c for c, p in self.patterns if p.search(name)), "other")
            self._memo[name] = cat
        return cat


def device_events(prof) -> List[Tuple[str, float, float]]:
    """``(name, start_s, end_s)`` of every operation the profiler saw on
    the card, on the profiler's clock, sorted by start."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            t0 = e.start_ns() * 1e-9
            out.append((e.name(), t0, t0 + e.duration_ns() * 1e-9))
    out.sort(key=lambda e: e[1])
    return out


def reduce(events: Sequence[Tuple[str, float, float]], cats: Categories,
           host_t0: float, spans: Spans, default_label: str,
           top: int = 10) -> Dict[str, Any]:
    """What the metrics read from a traced window: seconds and launches by
    category, the summed and the busy (union) device seconds, the longest
    operations and the longest idle gaps, each gap named by the host span
    it fell in.  ``events[0]`` is the marker, launched at ``host_t0``."""
    if not events:
        return {"seen": False}
    dev0 = events[0][1]
    by_cat: Dict[str, Dict[str, float]] = {}
    by_name: Dict[str, float] = {}
    busy, gaps = 0.0, []
    cur0, cur1 = events[0][1], events[0][2]
    total = 0.0
    for name, t0, t1 in events:
        d = t1 - t0
        total += d
        c = by_cat.setdefault(cats.of(name), {"s": 0.0, "n": 0})
        c["s"] += d
        c["n"] += 1
        by_name[name] = by_name.get(name, 0.0) + d
        if t0 > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, t0))
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    gaps.sort(key=lambda g: g[0] - g[1])
    named_gaps = []
    for g0, g1 in gaps[:top]:
        host_mid = host_t0 + ((g0 + g1) / 2 - dev0)
        named_gaps.append([spans.label_at(host_mid, default_label), g1 - g0])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"seen": True, "by_cat": by_cat, "device_s": total, "busy_s": busy,
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": named_gaps, "own": sorted(cats.own)}


class DeviceTrace:
    """The profiler over part of a run: :meth:`start` synchronises the
    card, starts tracing it and launches the marker at ``host_t0``;
    :meth:`stop` synchronises at ``host_t1`` and keeps the ``events``."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.host_t0 = self.host_t1 = None
        self.events: List[Tuple[str, float, float]] = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        marker = torch.zeros(1, device=self.device)
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.host_t0 = time.perf_counter()
        marker.add_(1.0)

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.host_t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.events = device_events(self.prof)
        self.prof = None

    @property
    def window_s(self) -> float:
        return self.host_t1 - self.host_t0

