"""Recovery-counter registry: one process-wide place where the port's
resilience paths (checkpoint writes, replayed epochs, shed requests,
corrupt steps skipped) record what they survived, and where the serving
stack records its latency histograms.

Port of the reference's `reliability/metrics.py` (which imports no JAX),
with its whole API: monotonic counters, last-value gauges, bounded
geometric-bucket latency histograms with trace exemplars, the wall-clock
sink (`observe`, for `utils.tracing.wall_clock`), the windowed shards of
`telemetry/window.py` under every counter and histogram, and the
mergeable exports (`export_state`, `window_state`) that
`telemetry/exposition.py` renders and merges. The key layout of
`snapshot()` is the reference's.

Latency claims need distributions, not totals: `Histogram` is a bounded
geometric-bucket (HDR-style) latency histogram — O(1) memory, lock-guarded
integer increments, ~6% relative quantile error across 1 us .. 80 s. The
serving hot path records `serving.request.{queue,transform,reply,e2e}`
through it; `snapshot()` exposes each histogram's p50/p95/p99 so a latency
percentile is one dict read away. `set_gauge` holds last-value operational
signals (queue depth, batch occupancy).
"""
from __future__ import annotations

import os
import threading
from bisect import bisect_right
from typing import Optional

# Windowed-shard defaults (telemetry/window.py attaches a ring of
# per-interval shards to every counter/histogram the registry creates):
# 10 s intervals x 31 shards = 300 s of history, enough for the SLO
# engine's long burn window. Interval/shard count are env-tunable;
# shards <= 0 disables windowing entirely.
WINDOW_INTERVAL_ENV = "MMLSPARK_TPU_WINDOW_INTERVAL"
WINDOW_SHARDS_ENV = "MMLSPARK_TPU_WINDOW_SHARDS"
_WINDOW_INTERVAL_DEFAULT = 10.0
_WINDOW_SHARDS_DEFAULT = 31


class Counter:
    """Monotonic counter; thread-safe. `window` (attached by the registry
    from telemetry/window.py) mirrors increments into a time-sharded ring
    so recent-rate reads don't require tracking counter deltas."""

    __slots__ = ("name", "_value", "_lock", "window")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()
        self.window = None

    def inc(self, n: int = 1) -> int:
        with self._lock:
            self._value += n
            value = self._value
        w = self.window
        if w is not None:
            w.inc(n)
        return value

    @property
    def value(self) -> int:
        return self._value

    def __repr__(self):
        return f"Counter({self.name}={self._value})"


# Shared bucket bounds (milliseconds): 256 geometric buckets spanning
# 1 us .. 80 s. One module-level tuple — histograms hold counts only.
_HIST_LO_MS = 1e-3
_HIST_HI_MS = 8e4
_HIST_BUCKETS = 256
_HIST_RATIO = (_HIST_HI_MS / _HIST_LO_MS) ** (1.0 / (_HIST_BUCKETS - 1))
_HIST_BOUNDS = tuple(_HIST_LO_MS * _HIST_RATIO ** i
                     for i in range(_HIST_BUCKETS - 1))


def histogram_bounds_ms() -> tuple:
    """The shared geometric bucket upper bounds (ms) every Histogram uses —
    public so telemetry exposition can render cumulative Prometheus buckets
    and merge cross-process states without poking privates."""
    return _HIST_BOUNDS


class Histogram:
    """Bounded-bucket latency histogram (HDR-style geometric buckets).

    `observe_ms` is O(log buckets) via bisect and never allocates;
    `percentile(p)` returns the geometric midpoint of the bucket holding
    the p-th sample, clamped to the observed min/max — bounded relative
    error regardless of how many samples arrive (the reason over a raw
    sample list: a day of traffic must not grow memory).

    **External bucket grids**: by default every Histogram shares the
    module-level geometric latency grid (1 us .. 80 s); `bounds` swaps in
    an externally-built grid of strictly-increasing upper edges — the
    value-domain form the quality sketches (telemetry/quality.py) build
    from reference-data quantiles. A custom-grid histogram keeps the
    whole mergeable-state contract: `state()` carries the grid under
    `"bounds"`, `from_state()` reconstructs it, and the round-trip is
    exact for the empty (all-zero counts, `min_ms: None`) and
    single-observation edges (pinned in tests/test_quality.py). Negative
    values are legal on a custom grid (feature domains are signed;
    latency's clamp-at-zero applies only to the default grid), and
    `percentile` falls back to the arithmetic bucket midpoint where a
    geometric one is undefined (lo <= 0). Custom-grid histograms live
    OUTSIDE the MetricsRegistry (exposition renders only the shared
    grid); `.state()` keys stay `sum_ms`/`min_ms`/`max_ms` for wire
    compatibility even when the unit is not milliseconds.

    **Merging**: `merge_state(state)` folds another histogram's raw state
    into this one — bucket counts sum elementwise (grids must match
    exactly), count/sum add, min/max extend; never averaged. It is the
    single merge kernel the cross-worker scrape merge and the quality
    sketches' chunk/fleet folds both reduce to.

    **Trace exemplars**: an observation that carries a `trace_id` leaves
    a last-per-bucket exemplar `(trace_id, ms, wall_ts)` — the link from
    a burning p99 bucket back to the tail-captured span tree of a request
    that landed in it. Bounded by construction (at most one slot per
    bucket, 256 total) and cheap by construction (the lock-held cost is
    one dict slot write; windowed shards carry NO exemplars). Callers
    that have no per-observation identity simply omit `trace_id` and pay
    nothing."""

    __slots__ = ("name", "_counts", "_count", "_sum_ms", "_min_ms",
                 "_max_ms", "_lock", "window", "_exemplars", "_bounds")

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
        # custom (value-domain) grids may be all-negative: the running
        # max must start below any legal observation there. The default
        # latency grid keeps 0.0 (observations are clamped >= 0 and the
        # empty-state export stays byte-identical to older writers).
        self._max_ms = 0.0 if self._bounds is _HIST_BOUNDS \
            else float("-inf")
        self._lock = threading.Lock()
        # time-sharded ring (telemetry/window.py), attached by the
        # registry: cumulative and windowed views share ONE bisect per
        # observation (the shards reuse this histogram's bucket index)
        self.window = None
        self._exemplars: dict = {}   # bucket idx -> (trace_id, ms, ts)

    def observe_ms(self, ms: float, trace_id: Optional[str] = None) -> None:
        if ms < 0.0 and self._bounds is _HIST_BOUNDS:
            # the latency grid starts at 0; custom (value-domain) grids
            # carry signed observations unclamped
            ms = 0.0
        idx = bisect_right(self._bounds, ms)
        if trace_id is not None:
            # timestamped OUTSIDE the lock (one perf_counter read); only
            # exemplar-carrying observations pay it
            from ..telemetry.spans import wall_now
            ex = (trace_id, ms, wall_now())
        else:
            ex = None
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum_ms += ms
            if ms < self._min_ms:
                self._min_ms = ms
            if ms > self._max_ms:
                self._max_ms = ms
            if ex is not None:
                self._exemplars[idx] = ex   # last writer wins, one slot
        w = self.window
        if w is not None:
            w.observe_idx(idx, ms)

    def observe(self, seconds: float) -> None:
        self.observe_ms(seconds * 1000.0)

    def exemplars(self) -> dict:
        """{bucket_index: (trace_id, ms, wall_ts)} — the last exemplar
        per bucket."""
        with self._lock:
            return dict(self._exemplars)

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
                        # custom grids may span <= 0 where a geometric
                        # midpoint is undefined — arithmetic midpoint,
                        # still clamped to the observed range below
                        rep = (lo + hi) / 2.0
                    else:
                        rep = hi
                    return min(max(rep, self._min_ms), self._max_ms)
            return self._max_ms  # unreachable: counts sum to _count

    def snapshot(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum_ms
            observed_max = self._max_ms if self._count else 0.0
        mean = total / count if count else 0.0
        # `sum`/`mean` (ms) let exposition compute rates without re-walking
        # buckets; existing keys stay stable (mean_ms == mean, kept for
        # older readers). `p999`/`max` expose the extreme tail burn-rate
        # math and the autotuner steer on.
        return {"count": count,
                "mean_ms": mean,
                "sum": total,
                "mean": mean,
                "p50": self.percentile(50.0),
                "p95": self.percentile(95.0),
                "p99": self.percentile(99.0),
                "p999": self.percentile(99.9),
                "max": observed_max}

    # -- raw state (exposition / cross-process merge) -------------------------
    def state(self) -> dict:
        """Raw bucket counts + aggregates — the mergeable form. Default
        histograms share the module-level bounds, so merging two states is
        an elementwise count sum; a custom external grid rides along under
        `"bounds"` so `from_state` round-trips it exactly (the shared grid
        is omitted for wire compatibility). The round-trip holds at the
        edges: an EMPTY histogram exports all-zero counts with
        `min_ms: None`, and a single observation exports its exact value
        as both min and max. Exemplars ride along (JSON keys are strings)
        when any exist; merges keep the newest per bucket."""
        with self._lock:
            out = {"counts": list(self._counts), "count": self._count,
                   "sum_ms": self._sum_ms,
                   "min_ms": self._min_ms if self._count else None,
                   "max_ms": self._max_ms if self._count else 0.0}
            if self._bounds is not _HIST_BOUNDS:
                out["bounds"] = list(self._bounds)
            if self._exemplars:
                out["exemplars"] = {str(i): list(e)
                                    for i, e in self._exemplars.items()}
        return out

    @classmethod
    def from_state(cls, name: str, state: dict) -> "Histogram":
        bounds = state.get("bounds")
        h = cls(name, bounds=tuple(bounds) if bounds is not None else None)
        counts = list(state["counts"])
        if len(counts) != len(h._counts):
            raise ValueError(
                f"histogram state has {len(counts)} buckets, expected "
                f"{len(h._counts)} (mixed framework versions, or a state "
                f"from a different external grid?)")
        h._counts = [int(c) for c in counts]
        h._count = int(state["count"])
        h._sum_ms = float(state["sum_ms"])
        mn = state.get("min_ms")
        h._min_ms = float("inf") if mn is None else float(mn)
        if h._count:
            h._max_ms = float(state.get("max_ms", 0.0))
        # empty: keep the constructor's sentinel so later observations
        # (negative ones included, on custom grids) still set the max
        for i, e in (state.get("exemplars") or {}).items():
            h._exemplars[int(i)] = tuple(e)
        return h

    def merge_state(self, state: dict) -> "Histogram":
        """Fold another histogram's `state()` into this one: bucket counts
        sum elementwise, count/sum add, min/max extend — counts sum, never
        averaged (the scrape-merge discipline, available per instance so
        the quality sketches can fold chunk and worker states through ONE
        kernel). Grids must match exactly; a mismatched grid raises rather
        than silently mis-binning. Exemplars keep the newest per bucket."""
        bounds = state.get("bounds")
        if bounds is not None:
            if tuple(float(b) for b in bounds) != tuple(self._bounds):
                raise ValueError(
                    f"cannot merge histogram states over different bucket "
                    f"grids ({self.name})")
        elif self._bounds is not _HIST_BOUNDS:
            raise ValueError(
                f"cannot merge a default-grid state into the external-grid "
                f"histogram {self.name}")
        counts = state["counts"]
        if len(counts) != len(self._counts):
            raise ValueError(
                f"histogram state has {len(counts)} buckets, expected "
                f"{len(self._counts)}")
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
            for i, e in (state.get("exemplars") or {}).items():
                idx = int(i)
                prev = self._exemplars.get(idx)
                if prev is None or float(e[2]) >= float(prev[2]):
                    self._exemplars[idx] = tuple(e)
        return self

    @property
    def bounds(self) -> tuple:
        """This histogram's bucket upper edges (the shared latency grid
        unless an external grid was passed at construction)."""
        return tuple(self._bounds)

    def __repr__(self):
        return (f"Histogram({self.name}: n={self._count}, "
                f"p50={self.percentile(50.0):.3f}ms)")


class MetricsRegistry:
    """Named counters, histograms, gauges + wall-clock observations.
    All methods thread-safe.

    Every counter/histogram also carries a WINDOWED view (a ring of
    per-interval shards, telemetry/window.py): `window_state(window_s)` /
    `export_state(window_s=...)` return the same mergeable shape as the
    cumulative export but covering only the last N seconds — the
    decision-grade signal admission control and autoscaling need (a
    cumulative percentile mixes the first request with the millionth)."""

    def __init__(self, window_interval_s: Optional[float] = None,
                 window_shards: Optional[int] = None):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._timings: dict = {}   # label -> [total_seconds, count]
        self._hists: dict = {}     # name -> Histogram
        self._gauges: dict = {}    # name -> float (last value wins)
        if window_interval_s is None:
            window_interval_s = float(os.environ.get(
                WINDOW_INTERVAL_ENV, _WINDOW_INTERVAL_DEFAULT)
                or _WINDOW_INTERVAL_DEFAULT)
        if window_shards is None:
            window_shards = int(os.environ.get(
                WINDOW_SHARDS_ENV, _WINDOW_SHARDS_DEFAULT)
                or _WINDOW_SHARDS_DEFAULT)
        self._win_interval = float(window_interval_s)
        self._win_shards = int(window_shards)

    # -- windowed shards ------------------------------------------------------
    @property
    def window_span_s(self) -> float:
        """Guaranteed windowed history: the current shard is partial, so
        only interval * (shards - 1) seconds are always covered."""
        if self._win_shards <= 1 or self._win_interval <= 0.0:
            return 0.0
        return self._win_interval * (self._win_shards - 1)

    def _attach_window(self, metric, kind: str) -> None:
        """Give a fresh counter/histogram its time-sharded ring. Lazy
        import: telemetry/window.py imports THIS module at its top level,
        so the upward reference must resolve at call time, not import
        time (same pattern as the exposition mounts in io/serving.py)."""
        if self._win_shards <= 1 or self._win_interval <= 0.0:
            return
        from ..telemetry.window import WindowedCounter, WindowedHistogram
        cls = WindowedHistogram if kind == "hist" else WindowedCounter
        metric.window = cls(self._win_interval, self._win_shards)

    def configure_windows(self, interval_s: float, shards: int) -> None:
        """Re-shard every windowed view (tests shrink the interval to make
        roll-off observable without waiting wall-clock minutes). Existing
        windowed contents are discarded — cumulative state is untouched."""
        with self._lock:
            self._win_interval = float(interval_s)
            self._win_shards = int(shards)
            metrics = ([(h, "hist") for h in self._hists.values()]
                       + [(c, "counter") for c in self._counters.values()])
        for metric, kind in metrics:
            metric.window = None
            self._attach_window(metric, kind)

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
                self._attach_window(c, "counter")
            return c

    def inc(self, name: str, n: int = 1) -> int:
        return self.counter(name).inc(n)

    def peek_counter(self, name: str) -> Optional[Counter]:
        """Non-creating lookup — readers (the SLO engine, exposition)
        must not materialize metrics on processes that never record
        them."""
        with self._lock:
            return self._counters.get(name)

    def get(self, name: str) -> int:
        with self._lock:
            c = self._counters.get(name)
        return c.value if c is not None else 0

    # -- tracing sink --------------------------------------------------------
    def observe(self, label: str, seconds: float) -> None:
        """`utils.tracing.wall_clock(label, sink=registry.observe)`."""
        with self._lock:
            t = self._timings.setdefault(label, [0.0, 0])
            t[0] += seconds
            t[1] += 1

    # -- histograms ----------------------------------------------------------
    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name)
                self._attach_window(h, "hist")
            return h

    def peek_histogram(self, name: str) -> Optional[Histogram]:
        """Non-creating lookup (see peek_counter)."""
        with self._lock:
            return self._hists.get(name)

    def observe_ms(self, name: str, ms: float,
                   trace_id: Optional[str] = None) -> None:
        self.histogram(name).observe_ms(ms, trace_id=trace_id)

    def percentile(self, name: str, p: float) -> float:
        with self._lock:
            h = self._hists.get(name)
        return h.percentile(p) if h is not None else 0.0

    # -- gauges --------------------------------------------------------------
    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def peek_gauge(self, name: str) -> Optional[float]:
        """Non-creating, absence-preserving lookup: None means the gauge
        was never set (a goodput SLO on a process that never trained must
        read as no-data, not as goodput 0.0)."""
        with self._lock:
            return self._gauges.get(name)

    # -- read side -----------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            out = {name: c.value for name, c in self._counters.items()}
            for label, (total, count) in self._timings.items():
                out[f"{label}.seconds"] = total
                out[f"{label}.count"] = count
            hists = list(self._hists.items())
            out.update(self._gauges)
        # histogram percentile math takes the per-histogram lock, not the
        # registry lock — observers on the hot path never wait on snapshot
        for name, h in hists:
            for k, v in h.snapshot().items():
                out[f"{name}.{k}"] = v
        return out

    def export_state(self, window_s: Optional[float] = None) -> dict:
        """JSON-serializable raw state: counters/timings/gauges plus each
        histogram's bucket counts — what `/metrics.json` ships and
        `telemetry.exposition.merge_states` sums across workers (snapshot()
        percentiles cannot be merged; bucket counts can, exactly).

        `window_s` switches counters and histograms to their WINDOWED
        view (last N seconds, shard-aligned) in the same mergeable shape;
        the effective window rides along as `window_s` (clamped to the
        ring's guaranteed span). Timings and gauges have no windowed form
        and are passed through cumulative/last-value."""
        if window_s is not None:
            return self.window_state(window_s)
        with self._lock:
            counters = {n: c.value for n, c in self._counters.items()}
            timings = {l: list(t) for l, t in self._timings.items()}
            gauges = dict(self._gauges)
            hists = list(self._hists.items())
        return {"counters": counters, "timings": timings, "gauges": gauges,
                "hists": {n: h.state() for n, h in hists}}

    def window_state(self, window_s: float) -> dict:
        """Windowed raw state (see export_state). Metrics created before
        windowing was enabled — or with windowing disabled — are omitted
        rather than silently reported cumulative."""
        span = self.window_span_s
        eff = min(float(window_s), span) if span > 0.0 else 0.0
        with self._lock:
            counters = list(self._counters.items())
            timings = {l: list(t) for l, t in self._timings.items()}
            gauges = dict(self._gauges)
            hists = list(self._hists.items())
        out = {"window_s": eff, "window_requested_s": float(window_s),
               "counters": {}, "timings": timings, "gauges": gauges,
               "hists": {}}
        for name, c in counters:
            if c.window is not None:
                out["counters"][name] = c.window.total(eff)
        for name, h in hists:
            if h.window is not None:
                out["hists"][name] = h.window.state(eff)
        return out

    def window_snapshot(self, window_s: float) -> dict:
        """Flat snapshot()-shaped view of the last N seconds — windowed
        percentiles are recomputed from the merged shard buckets, never
        averaged across shards."""
        from ..telemetry.exposition import state_snapshot
        return state_snapshot(self.window_state(window_s))

    def reset(self, prefix: Optional[str] = None) -> None:
        """Zero counters/timings/histograms/gauges (tests isolate scenarios
        with this). `prefix` limits the reset to one subsystem's names."""
        with self._lock:
            if prefix is None:
                self._counters.clear()
                self._timings.clear()
                self._hists.clear()
                self._gauges.clear()
                return
            for store in (self._counters, self._timings, self._hists,
                          self._gauges):
                for name in [n for n in store if n.startswith(prefix)]:
                    del store[name]


# Process-wide default: library code records here unless handed a private
# registry (mirrors how the stage registry / shared singletons work).
reliability_metrics = MetricsRegistry()
