"""Live telemetry regression watcher: threshold + median-shift
change-point detection over watched series.

Port of the reference's `telemetry/watch.py` (host Python):

- **WatchRule**: one watched series key with either/both detectors: a
  *threshold* bound (``max_value`` / ``min_value`` on the latest sample)
  and a *median-shift* change-point (``shift`` factor: the median of the
  last ``window`` samples against the median of the ``window`` samples
  before them; directions ``up``/``down``/``both``). Medians, not means:
  one GC pause must not trip a latency rule.
- **TelemetryWatcher**: evaluates every rule over `poller.series(key)`
  (or an injected ``series`` dict: detection is a pure function of the
  series, so tests drive it deterministically without threads or
  sleeps). A rule's False->True transition emits a `telemetry.watch.trip`
  event and counts `telemetry.watch.trips`; the `telemetry.watch.tripped`
  gauge holds the number of currently-tripped rules. Each trip and
  recovery also notifies a flight recorder: the `recorder` its caller
  passes in, else the process one (`telemetry.perf`), with a latch of
  its own per rule. The reference's `TelemetryPoller` is item 27: pass a
  poller-like object with `series(key)`, or `series=`.
- Optional background cadence: `start(interval_s)` runs `check()` on a
  daemon thread (Event.wait is the sleep AND the stop signal); `stop()`
  joins it.
"""
from __future__ import annotations

import statistics
import threading
from typing import NamedTuple, Optional

from ..reliability.metrics import reliability_metrics
from . import names as tnames
from .spans import get_tracer


class WatchRule(NamedTuple):
    """One watched series (see module docstring). `key` addresses the
    poller's merged-metric namespace (e.g. ``serving.request.e2e.p99``,
    ``train.goodput``). At least one detector must be configured."""
    key: str
    max_value: Optional[float] = None   # threshold: latest > max trips
    min_value: Optional[float] = None   # threshold: latest < min trips
    shift: Optional[float] = None       # median-shift factor (> 1.0)
    direction: str = "both"             # shift direction: up/down/both
    window: int = 8                     # samples per shift side
    min_samples: int = 4                # below this the rule stays quiet


def evaluate_rule(rule: WatchRule, series: list) -> Optional[dict]:
    """Pure detection: the breach description for `rule` over
    ``[(t, value), ...]``, or None. Deterministic — same series, same
    verdict — so the watcher's behavior is pinned by value tables, not
    sleeps."""
    vals = [float(v) for _, v in series]
    if len(vals) < max(int(rule.min_samples), 1):
        return None
    last = vals[-1]
    if rule.max_value is not None and last > rule.max_value:
        return {"key": rule.key, "kind": "threshold", "value": last,
                "bound": float(rule.max_value), "direction": "up"}
    if rule.min_value is not None and last < rule.min_value:
        return {"key": rule.key, "kind": "threshold", "value": last,
                "bound": float(rule.min_value), "direction": "down"}
    if rule.shift is not None and rule.shift > 0.0:
        w = max(int(rule.window), 2)
        if len(vals) >= 2 * w:
            baseline = statistics.median(vals[-2 * w:-w])
            recent = statistics.median(vals[-w:])
            up = (recent > rule.shift * baseline) if baseline > 0.0 \
                else recent > 0.0
            down = baseline > 0.0 and recent < baseline / rule.shift
            if ((up and rule.direction in ("up", "both"))
                    or (down and rule.direction in ("down", "both"))):
                return {"key": rule.key, "kind": "shift",
                        "value": recent, "baseline": baseline,
                        "factor": float(rule.shift),
                        "direction": "up" if up else "down"}
    return None


class TelemetryWatcher:
    """Rule evaluation + trip-transition bookkeeping over a poller's
    retained series (module docstring)."""

    def __init__(self, poller=None, rules=(), registry=None, tracer=None,
                 recorder=None):
        self.poller = poller
        self.rules = [r if isinstance(r, WatchRule) else WatchRule(**r)
                      for r in rules]
        for r in self.rules:
            if (r.max_value is None and r.min_value is None
                    and r.shift is None):
                raise ValueError(
                    f"rule for {r.key!r} has no detector configured")
        self._metrics = registry if registry is not None \
            else reliability_metrics
        self._tracer = tracer
        self._recorder = recorder
        self._tripped: dict = {}       # rule key -> last breach dict
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._trips_total = 0

    # -- detection ------------------------------------------------------------
    def check(self, series: Optional[dict] = None) -> list:
        """One detection pass; returns the NEW trips (transitions only).
        `series` overrides the poller read per key ({key: [(t, v), ...]})
        — the deterministic test/replay entry point. Never raises:
        watching is observability."""
        trips: list = []
        recoveries: list = []
        tracer = self._tracer if self._tracer is not None else get_tracer()
        for rule in self.rules:
            try:
                s = (series.get(rule.key, []) if series is not None
                     else self.poller.series(rule.key)
                     if self.poller is not None else [])
                breach = evaluate_rule(rule, s)
            except Exception:  # noqa: BLE001 - a torn series loses one pass
                continue
            with self._lock:
                was = rule.key in self._tripped
                if breach is not None:
                    self._tripped[rule.key] = breach
                    if not was:
                        self._trips_total += 1
                else:
                    self._tripped.pop(rule.key, None)
                now_tripped = len(self._tripped)
            if breach is not None and not was:
                trips.append(breach)
                self._metrics.inc(tnames.TELEMETRY_WATCH_TRIPS)
                tracer.event(tnames.TELEMETRY_WATCH_TRIP_EVENT, **breach)
            elif breach is None and was:
                recoveries.append(rule.key)
            self._metrics.set_gauge(tnames.TELEMETRY_WATCH_TRIPPED,
                                    now_tripped)
        # the recorder is a non-SLO flight source: each rule gets its own
        # latch (source="watch:<key>"), trips arm it, recoveries re-arm —
        # a live regression leaves a bundle, not just an event line
        recorder = self._recorder
        if recorder is None:
            try:
                from .perf import get_flight_recorder
                recorder = get_flight_recorder()
            except Exception:  # noqa: BLE001
                recorder = None
        if recorder is not None:
            for breach in trips:
                try:
                    recorder.on_verdict(
                        {"burning": True, "watch": breach},
                        reason=f"watch-{breach['key']}",
                        source=f"watch:{breach['key']}")
                except Exception:  # noqa: BLE001 - never kills the watcher
                    pass
            for key in recoveries:
                try:
                    recorder.on_verdict({"burning": False},
                                        source=f"watch:{key}")
                except Exception:  # noqa: BLE001
                    pass
        return trips

    # -- read side ------------------------------------------------------------
    def tripped(self) -> dict:
        """Currently-tripped rules: {key: last breach dict}."""
        with self._lock:
            return {k: dict(v) for k, v in self._tripped.items()}

    def stats(self) -> dict:
        with self._lock:
            return {"rules": len(self.rules),
                    "tripped": len(self._tripped),
                    "trips_total": self._trips_total,
                    "running": self._thread is not None
                    and self._thread.is_alive()}

    # -- background cadence ---------------------------------------------------
    def start(self, interval_s: float = 30.0) -> "TelemetryWatcher":
        if self._thread is not None:
            raise RuntimeError("watcher already started")
        if interval_s <= 0.0:
            raise ValueError("interval_s must be > 0")
        self._stop.clear()
        self._interval_s = float(interval_s)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="telemetry-watch")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while True:
            self.check()
            if self._stop.wait(self._interval_s):
                return
