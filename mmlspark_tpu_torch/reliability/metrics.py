"""Recovery-counter registry: one process-wide place where the port's
resilience paths (checkpoint writes, coalesced snapshots, corrupt steps
skipped) record what they survived.

Port of the reference's `reliability/metrics.py` (which imports no JAX),
kept to what the port records into: monotonic counters, last-value gauges
and bounded geometric-bucket latency histograms (`observe_ms`), read back
through `get` and `snapshot` in the reference's key layout. The
reference's wall-clock sink, windowed shards, exemplars, custom grids and
mergeable exports belong to telemetry (ROADMAP Queue 1 item 23).
"""
from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Optional


class Counter:
    """Monotonic counter; thread-safe."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            return self._value

    @property
    def value(self) -> int:
        return self._value

    def __repr__(self):
        return f"Counter({self.name}={self._value})"


# Shared bucket bounds (milliseconds): 256 geometric buckets spanning
# 1 us .. 80 s, the reference's grid
_HIST_LO_MS = 1e-3
_HIST_HI_MS = 8e4
_HIST_BUCKETS = 256
_HIST_RATIO = (_HIST_HI_MS / _HIST_LO_MS) ** (1.0 / (_HIST_BUCKETS - 1))
_HIST_BOUNDS = tuple(_HIST_LO_MS * _HIST_RATIO ** i
                     for i in range(_HIST_BUCKETS - 1))


class Histogram:
    """Bounded-bucket latency histogram (HDR-style geometric buckets):
    O(1) memory, ~6% relative quantile error across 1 us .. 80 s.
    `percentile(p)` is the geometric midpoint of the bucket holding the
    p-th sample, clamped to the observed min/max."""

    def __init__(self, name: str):
        self.name = name
        self._counts = [0] * (len(_HIST_BOUNDS) + 1)
        self._count = 0
        self._sum_ms = 0.0
        self._min_ms = float("inf")
        self._max_ms = 0.0
        self._lock = threading.Lock()

    def observe_ms(self, ms: float) -> None:
        ms = max(ms, 0.0)
        idx = bisect_right(_HIST_BOUNDS, ms)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum_ms += ms
            self._min_ms = min(self._min_ms, ms)
            self._max_ms = max(self._max_ms, ms)

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, p: float) -> float:
        """Latency (ms) at percentile p in [0, 100]; 0.0 when empty."""
        with self._lock:
            if not self._count:
                return 0.0
            target = max(1, int(round(self._count * p / 100.0)))
            seen = 0
            for idx, c in enumerate(self._counts):
                seen += c
                if seen >= target:
                    if idx >= len(_HIST_BOUNDS):
                        return self._max_ms   # open-ended overflow bucket
                    lo = _HIST_BOUNDS[idx - 1] if idx > 0 else 0.0
                    hi = _HIST_BOUNDS[idx]
                    rep = (lo * hi) ** 0.5 if lo > 0.0 else hi
                    return min(max(rep, self._min_ms), self._max_ms)
            return self._max_ms

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum_ms
            observed_max = self._max_ms if self._count else 0.0
        mean = total / count if count else 0.0
        return {"count": count, "mean_ms": mean, "sum": total, "mean": mean,
                "p50": self.percentile(50.0), "p95": self.percentile(95.0),
                "p99": self.percentile(99.0), "p999": self.percentile(99.9),
                "max": observed_max}


class MetricsRegistry:
    """Named counters, histograms and gauges. Every method is
    thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._hists: dict = {}     # name -> Histogram
        self._gauges: dict = {}    # name -> float (last value wins)

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def inc(self, name: str, n: int = 1) -> int:
        return self.counter(name).inc(n)

    def get(self, name: str) -> int:
        with self._lock:
            c = self._counters.get(name)
        return c.value if c is not None else 0

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name)
            return h

    def observe_ms(self, name: str, ms: float) -> None:
        self.histogram(name).observe_ms(ms)

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def snapshot(self) -> dict:
        """Counters, gauges and `{histogram}.{p50, p95, ...}`, flat."""
        with self._lock:
            out = {name: c.value for name, c in self._counters.items()}
            hists = list(self._hists.items())
            out.update(self._gauges)
        for name, h in hists:
            for k, v in h.snapshot().items():
                out[f"{name}.{k}"] = v
        return out

    def reset(self, prefix: Optional[str] = None) -> None:
        """Zero everything, or the names under `prefix`."""
        with self._lock:
            for store in (self._counters, self._hists, self._gauges):
                for name in [n for n in store
                             if prefix is None or n.startswith(prefix)]:
                    del store[name]


# Process-wide default: library code records here unless handed a private
# registry.
reliability_metrics = MetricsRegistry()
