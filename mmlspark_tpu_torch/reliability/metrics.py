"""Recovery-counter registry: one process-wide place where the port's
resilience paths (checkpoint writes, coalesced snapshots, corrupt steps
skipped) record what they survived.

Port of the reference's `reliability/metrics.py` (which imports no JAX),
kept to what the port records into: monotonic counters, last-value gauges,
bounded geometric-bucket latency histograms (`observe_ms`) and the
wall-clock sink (`observe`, for `utils.tracing.wall_clock`), read back
through `get`, `gauge`, `peek_gauge` and `snapshot` in the reference's key
layout. A histogram may carry an external grid (`bounds`, the quality
sketches' value-domain buckets) and has the reference's mergeable state
(`state`, `from_state`, `merge_state`). The reference's windowed shards,
exemplars and registry-wide exports belong to telemetry (ROADMAP Queue 1
item 23).
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
    p-th sample, clamped to the observed min/max.

    `bounds` swaps in an external grid of strictly increasing upper edges
    (the quality sketches' quantile edges): negative values are legal
    there, and `percentile` takes the arithmetic midpoint where the
    geometric one is undefined. `state()` / `from_state()` / `merge_state`
    are the reference's mergeable form: counts sum elementwise over one
    grid, never averaged."""

    def __init__(self, name: str, bounds: Optional[tuple] = None):
        self.name = name
        if bounds is None:
            self._bounds = _HIST_BOUNDS
        else:
            b = tuple(float(x) for x in bounds)
            if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
                raise ValueError(
                    "bounds must be a non-empty strictly-increasing grid "
                    "of bucket upper edges")
            self._bounds = b
        self._counts = [0] * (len(self._bounds) + 1)
        self._count = 0
        self._sum_ms = 0.0
        self._min_ms = float("inf")
        # an external grid may be all negative: its running max starts
        # below any observation
        self._max_ms = 0.0 if self._bounds is _HIST_BOUNDS \
            else float("-inf")
        self._lock = threading.Lock()

    def observe_ms(self, ms: float) -> None:
        if ms < 0.0 and self._bounds is _HIST_BOUNDS:
            ms = 0.0
        idx = bisect_right(self._bounds, ms)
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
                    if idx >= len(self._bounds):
                        return self._max_ms   # open-ended overflow bucket
                    lo = self._bounds[idx - 1] if idx > 0 else 0.0
                    hi = self._bounds[idx]
                    if lo > 0.0:
                        rep = (lo * hi) ** 0.5
                    elif self._bounds is not _HIST_BOUNDS:
                        rep = (lo + hi) / 2.0
                    else:
                        rep = hi
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

    def state(self) -> dict:
        """Raw bucket counts and aggregates, the reference's layout: an
        empty histogram has `min_ms` None; an external grid rides along
        under `bounds`."""
        with self._lock:
            out = {"counts": list(self._counts), "count": self._count,
                   "sum_ms": self._sum_ms,
                   "min_ms": self._min_ms if self._count else None,
                   "max_ms": self._max_ms if self._count else 0.0}
            if self._bounds is not _HIST_BOUNDS:
                out["bounds"] = list(self._bounds)
        return out

    @classmethod
    def from_state(cls, name: str, state: dict) -> "Histogram":
        bounds = state.get("bounds")
        h = cls(name, bounds=tuple(bounds) if bounds is not None else None)
        counts = list(state["counts"])
        if len(counts) != len(h._counts):
            raise ValueError(f"histogram state has {len(counts)} buckets, "
                             f"expected {len(h._counts)}")
        h._counts = [int(c) for c in counts]
        h._count = int(state["count"])
        h._sum_ms = float(state["sum_ms"])
        mn = state.get("min_ms")
        h._min_ms = float("inf") if mn is None else float(mn)
        if h._count:
            h._max_ms = float(state.get("max_ms", 0.0))
        return h

    def merge_state(self, state: dict) -> "Histogram":
        """Fold another histogram's `state()` in: counts sum, count and
        sum add, min and max extend. The grids must match exactly."""
        bounds = state.get("bounds")
        if bounds is not None:
            if tuple(float(b) for b in bounds) != tuple(self._bounds):
                raise ValueError(f"cannot merge histogram states over "
                                 f"different bucket grids ({self.name})")
        elif self._bounds is not _HIST_BOUNDS:
            raise ValueError(f"cannot merge a default-grid state into the "
                             f"external-grid histogram {self.name}")
        counts = state["counts"]
        if len(counts) != len(self._counts):
            raise ValueError(f"histogram state has {len(counts)} buckets, "
                             f"expected {len(self._counts)}")
        mn = state.get("min_ms")
        with self._lock:
            for i, c in enumerate(counts):
                self._counts[i] += int(c)
            self._count += int(state["count"])
            self._sum_ms += float(state["sum_ms"])
            if mn is not None and float(mn) < self._min_ms:
                self._min_ms = float(mn)
            mx = float(state.get("max_ms", 0.0))
            if int(state["count"]) and mx > self._max_ms:
                self._max_ms = mx
        return self


class MetricsRegistry:
    """Named counters, histograms and gauges. Every method is
    thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._timings: dict = {}   # label -> [total_seconds, count]
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

    def observe(self, label: str, seconds: float) -> None:
        """`utils.tracing.wall_clock(label, sink=registry.observe)`."""
        with self._lock:
            t = self._timings.setdefault(label, [0.0, 0])
            t[0] += seconds
            t[1] += 1

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

    def gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def peek_gauge(self, name: str) -> Optional[float]:
        """The gauge's last value, or None when it was never set."""
        with self._lock:
            return self._gauges.get(name)

    def snapshot(self) -> dict:
        """Counters, `{label}.seconds` / `{label}.count` of the wall
        clocks, gauges and `{histogram}.{p50, p95, ...}`, flat."""
        with self._lock:
            out = {name: c.value for name, c in self._counters.items()}
            for label, (total, count) in self._timings.items():
                out[f"{label}.seconds"] = total
                out[f"{label}.count"] = count
            hists = list(self._hists.items())
            out.update(self._gauges)
        for name, h in hists:
            for k, v in h.snapshot().items():
                out[f"{name}.{k}"] = v
        return out

    def reset(self, prefix: Optional[str] = None) -> None:
        """Zero everything, or the names under `prefix`."""
        with self._lock:
            for store in (self._counters, self._timings, self._hists,
                          self._gauges):
                for name in [n for n in store
                             if prefix is None or n.startswith(prefix)]:
                    del store[name]


# Process-wide default: library code records here unless handed a private
# registry.
reliability_metrics = MetricsRegistry()
