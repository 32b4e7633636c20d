"""Typed metrics: Counter / Gauge / Histogram on a named registry.

The serving layers used to keep flat ``stats()`` dicts that mixed
cumulative counters (``kv_pages_sent``) with point-in-time gauges
(``pool_free_pages``) — indistinguishable to a consumer that wants to
rate, diff, or reset them.  Here every metric declares its kind once;
``Registry.reset()`` clears counters (and histogram samples) but never
gauges, and ``snapshot()`` flattens back into the dict shape the
existing consumers read.

Histograms keep a bounded, deterministically decimated sample list for
streaming p50/p99 — no randomness (reservoir sampling would make runs
irreproducible), no unbounded memory: when the sample list exceeds its
cap it is sorted and every second sample dropped, which preserves the
quantile shape to well under the noise floor of anything we measure.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Union

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "counter_property",
]


class Counter:
    """Monotonic cumulative count.  Cleared by :meth:`Registry.reset`."""

    kind = "counter"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        self.value += n

    def get(self) -> Union[int, float]:
        return self.value


class Gauge:
    """Point-in-time value.  Survives :meth:`Registry.reset`."""

    kind = "gauge"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def set(self, v: Union[int, float]) -> None:
        self.value = v

    def get(self) -> Union[int, float]:
        return self.value


class Histogram:
    """Streaming distribution with deterministic bounded memory.

    ``observe(v)`` is O(1) amortised; ``quantile(q)`` sorts the current
    samples (cheap at the cap).  ``count``/``total`` are exact even
    after decimation; quantiles are approximate once the cap is hit.
    """

    kind = "histogram"
    __slots__ = ("name", "cap", "count", "total", "_samples", "_sorted")

    def __init__(self, name: str, cap: int = 4096):
        if cap < 2:
            raise ValueError("histogram cap must be >= 2")
        self.name = name
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self._samples: List[float] = []
        self._sorted = True

    def observe(self, v: Union[int, float]) -> None:
        self.count += 1
        self.total += v
        self._samples.append(float(v))
        self._sorted = False
        if len(self._samples) > self.cap:
            self._samples.sort()
            # deterministic decimation: keep every second sample
            self._samples = self._samples[::2]
            self._sorted = True

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile over the current samples.

        Defined explicitly at the edges: n=0 returns 0.0 (no data), n=1
        returns the single sample for every q.  For n >= 2 the rank
        ``q * (n - 1)`` interpolates between its two neighbours — so a
        tiny sample no longer degenerates to its max (the old
        index-truncation rule mapped p99 of [a, b] to b outright)."""
        if not self._samples:
            return 0.0
        if not self._sorted:
            self._samples.sort()
            self._sorted = True
        n = len(self._samples)
        if n == 1:
            return self._samples[0]
        pos = min(max(q, 0.0), 1.0) * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        return self._samples[lo] + (self._samples[hi] - self._samples[lo]) * frac

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def get(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.p50,
            "p99": self.p99,
        }

    def clear(self) -> None:
        self.count = 0
        self.total = 0.0
        self._samples = []
        self._sorted = True


Metric = Union[Counter, Gauge, Histogram]


class Registry:
    """Named metrics with kind checking.

    ``counter(name)`` / ``gauge(name)`` / ``histogram(name)`` are
    get-or-create; asking for an existing name under a different kind
    raises (the schema ambiguity the typed registry exists to prevent).
    """

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, cls, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {m.kind}, not a {cls.kind}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, cap: int = 4096) -> Histogram:
        h = self._metrics.get(name)
        if h is None:
            return self._get(name, Histogram, cap=cap)
        return self._get(name, Histogram)

    def kind(self, name: str) -> str:
        return self._metrics[name].kind

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self) -> Iterator[Metric]:
        return iter(self._metrics.values())

    def snapshot(self) -> Dict[str, Union[int, float]]:
        """Flatten to the ``stats()`` dict shape: counters and gauges map
        to their value, histograms expand to ``name_count`` / ``name_p50``
        / ``name_p99`` / ``name_mean``."""
        out: Dict[str, Union[int, float]] = {}
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                out[f"{m.name}_count"] = m.count
                out[f"{m.name}_mean"] = m.mean
                out[f"{m.name}_p50"] = m.p50
                out[f"{m.name}_p99"] = m.p99
            else:
                out[m.name] = m.value
        return out

    def reset(self) -> None:
        """Zero the cumulative metrics (counters, histogram samples).
        Gauges describe *current* state, not history — they survive."""
        for m in self._metrics.values():
            if isinstance(m, Counter):
                m.value = 0
            elif isinstance(m, Histogram):
                m.clear()


def counter_property(name: str) -> property:
    """Class-level proxy migrating a plain integer attribute onto the
    owner's typed registry: reads and writes go to ``self.metrics``'s
    Counter of the given name, so existing ``obj.x += 1`` increment
    sites keep their syntax while the value lives on the registry (with
    an explicit kind, visible to ``snapshot()`` and ``reset()``)."""

    def fget(self):
        return self.metrics.counter(name).value

    def fset(self, v):
        self.metrics.counter(name).value = v

    return property(fget, fset)
