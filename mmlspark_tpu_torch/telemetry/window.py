"""Windowed aggregation: time-sharded rings under every counter and
histogram of `reliability.metrics.MetricsRegistry`.

Port of the reference's `telemetry/window.py` (stdlib only). Cumulative
percentiles mix the first request with the millionth; these rings give
every metric a bounded recent view without a second bookkeeping path at
the call sites:

- `WindowedHistogram` — a ring of per-interval bucket-count shards sharing
  the module-level geometric bounds of `reliability.metrics.Histogram`.
  The owning histogram forwards `(bucket_idx, ms)` from its own bisect,
  so the windowed view costs one extra list increment per observation.
  `state(window_s)` merges the shards covering the last N seconds into
  the standard mergeable histogram-state dict — percentiles are then
  recomputed from merged bucket counts (exactly the cross-worker merge
  discipline `scrape_cluster` already enforces), never averaged.
- `WindowedCounter` — the same ring over plain ints; `total(window_s)` is
  the count landed in the last N seconds (error-rate numerators and
  denominators for the SLO engine).

Sharding model: wall time is cut into fixed intervals; shard `k` covers
`[k*interval, (k+1)*interval)` and lives in ring slot `k % n`. Writing to
a slot whose recorded interval is stale resets it first — expiry is
O(1) amortized and needs no sweeper thread. A read over `window_s`
includes every shard whose interval overlaps `(now - window_s, now]`, so
the answer covers between `window_s` and `window_s + interval` of
history (standard ring-buffer windowing slack; the interval is the
resolution knob). Memory is `shards * buckets` ints per histogram —
bounded regardless of traffic, same contract as the cumulative buckets.

The clock is injectable (monotonic by default) so roll-off is testable
without wall-clock sleeps.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..reliability.metrics import histogram_bounds_ms

# bucket count of the shared geometric layout (bounds + one overflow)
_HIST_BUCKETS = len(histogram_bounds_ms()) + 1


class _Ring:
    """Slot bookkeeping shared by both windowed kinds: maps now -> the
    live slot (resetting stale ones) and enumerates the slots covering a
    lookback window. Callers hold their own lock around every use."""

    __slots__ = ("interval_s", "n", "_epochs", "_clock")

    def __init__(self, interval_s: float, shards: int,
                 clock: Callable[[], float]):
        if interval_s <= 0.0 or shards <= 1:
            raise ValueError("windowed ring needs interval_s > 0 and "
                             ">= 2 shards (one is always partial)")
        self.interval_s = float(interval_s)
        self.n = int(shards)
        # interval index currently stored in each slot; None = never used
        self._epochs: list = [None] * self.n
        self._clock = clock

    def slot(self) -> tuple:
        """(slot_index, is_stale): the slot for the current interval;
        is_stale means the caller must reset the slot's payload before
        writing (a previous interval's data still lives there)."""
        k = int(self._clock() // self.interval_s)
        i = k % self.n
        stale = self._epochs[i] != k
        if stale:
            self._epochs[i] = k
        return i, stale

    def live_slots(self, window_s: float) -> list:
        """Slot indices whose interval overlaps `(now - window_s, now]`.
        Shard k covers [k*iv, (k+1)*iv): it overlaps iff its end is past
        the window start and its start is not in the future."""
        now = self._clock()
        k_now = int(now // self.interval_s)
        k_min = int(max(now - float(window_s), 0.0) // self.interval_s)
        out = []
        for i, epoch in enumerate(self._epochs):
            if epoch is not None and k_min <= epoch <= k_now:
                out.append(i)
        return out

    @property
    def span_s(self) -> float:
        """Guaranteed lookback (the current shard is partial)."""
        return self.interval_s * (self.n - 1)


class WindowedHistogram:
    """Ring of per-interval histogram shards (counts + count/sum/min/max
    per shard), merged on read. Attached to a cumulative Histogram by
    `MetricsRegistry`; `observe_idx` reuses the owner's bucket bisect."""

    __slots__ = ("_ring", "_counts", "_count", "_sum_ms", "_min_ms",
                 "_max_ms", "_lock")

    def __init__(self, interval_s: float, shards: int,
                 clock: Callable[[], float] = time.monotonic):
        self._ring = _Ring(interval_s, shards, clock)
        n = self._ring.n
        self._counts = [[0] * _HIST_BUCKETS for _ in range(n)]
        self._count = [0] * n
        self._sum_ms = [0.0] * n
        self._min_ms = [float("inf")] * n
        self._max_ms = [0.0] * n
        self._lock = threading.Lock()

    def _reset_slot(self, i: int) -> None:
        counts = self._counts[i]
        for j in range(_HIST_BUCKETS):
            counts[j] = 0
        self._count[i] = 0
        self._sum_ms[i] = 0.0
        self._min_ms[i] = float("inf")
        self._max_ms[i] = 0.0

    def observe_idx(self, idx: int, ms: float) -> None:
        """One observation into the current shard; `idx` is the bucket
        index the owning Histogram already computed."""
        with self._lock:
            i, stale = self._ring.slot()
            if stale:
                self._reset_slot(i)
            self._counts[i][idx] += 1
            self._count[i] += 1
            self._sum_ms[i] += ms
            if ms < self._min_ms[i]:
                self._min_ms[i] = ms
            if ms > self._max_ms[i]:
                self._max_ms[i] = ms

    def state(self, window_s: float) -> dict:
        """Mergeable histogram-state dict (same shape as
        `Histogram.state()`) covering the shards of the last `window_s`
        seconds — elementwise bucket-count sums, so `merge_states` and
        `Histogram.from_state` consume it unchanged."""
        counts = [0] * _HIST_BUCKETS
        count = 0
        sum_ms = 0.0
        min_ms = float("inf")
        max_ms = 0.0
        with self._lock:
            for i in self._ring.live_slots(window_s):
                shard = self._counts[i]
                for j in range(_HIST_BUCKETS):
                    counts[j] += shard[j]
                count += self._count[i]
                sum_ms += self._sum_ms[i]
                if self._min_ms[i] < min_ms:
                    min_ms = self._min_ms[i]
                if self._max_ms[i] > max_ms:
                    max_ms = self._max_ms[i]
        return {"counts": counts, "count": count, "sum_ms": sum_ms,
                "min_ms": None if count == 0 else min_ms,
                "max_ms": max_ms}

    def snapshot(self, window_s: float, name: str = "window") -> dict:
        """snapshot()-shaped percentiles over the window, recomputed from
        the merged shard buckets."""
        from ..reliability.metrics import Histogram
        return Histogram.from_state(name, self.state(window_s)).snapshot()

    @property
    def span_s(self) -> float:
        return self._ring.span_s


class WindowedCounter:
    """Ring of per-interval increment totals; `total(window_s)` is the
    count from the last N seconds."""

    __slots__ = ("_ring", "_totals", "_lock")

    def __init__(self, interval_s: float, shards: int,
                 clock: Callable[[], float] = time.monotonic):
        self._ring = _Ring(interval_s, shards, clock)
        self._totals = [0] * self._ring.n
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            i, stale = self._ring.slot()
            if stale:
                self._totals[i] = 0
            self._totals[i] += n

    def total(self, window_s: float) -> int:
        with self._lock:
            return sum(self._totals[i]
                       for i in self._ring.live_slots(window_s))

    @property
    def span_s(self) -> float:
        return self._ring.span_s


def set_clock(metric, clock: Callable[[], float]) -> None:
    """Swap a windowed metric's clock (tests drive roll-off with a fake
    clock instead of sleeping). Existing shard epochs are kept — the fake
    clock should start at or after the real one's last reading, or start
    from a fresh metric."""
    window = getattr(metric, "window", metric)
    window._ring._clock = clock
