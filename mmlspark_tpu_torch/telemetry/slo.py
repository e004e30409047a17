"""SLO engine: declared objectives, multi-window burn rates, mergeable
verdicts.

Port of the reference's `telemetry/slo.py` (host Python; the same
objectives over the same windowed registry give the same verdicts).
Every verdict notifies the process flight recorder (`telemetry.perf`),
so an ok -> burning transition dumps one debug bundle; `verdict(
notify=False)` is for readers that must not re-trigger it.

An SLO turns a latency histogram into a yes/no question a control plane
can act on: "p99 of `serving.request.e2e` under 250 ms over the last
60 s" or "5xx rate under 1%". The classic formulation (Google SRE
workbook; *CTA-Pipelining*'s scale-for-tail-latency argument in
PAPERS.md) is *error-budget burn rate*:

- a latency objective at quantile q allows a fraction `1 - q/100` of
  requests over the threshold. The observed over-threshold fraction
  divided by that allowance is the burn rate — burn 1.0 means exactly
  on budget, 10.0 means the budget burns ten times too fast.
- an error-rate objective's burn is `observed_rate / budget`.

Each objective is evaluated over TWO windows — the declared one and a
`long_factor` multiple — and `burning` requires both over 1.0: the short
window gives fast detection, the long window stops a single slow request
from flapping the verdict (multi-window, multi-burn-rate alerting).

Everything reads the windowed shards `telemetry/window.py` attaches to
the process registry, so the verdict reflects the last N seconds, not
process history. Violation counts come from histogram BUCKETS (count of
observations in buckets above the threshold's bucket), which makes
worker verdicts mergeable the same way histograms are: `merge_verdicts`
sums counts across workers and recomputes rates/burns — never averages
— mirroring `scrape_cluster`'s bucket-merge discipline. The threshold
snaps down to a bucket boundary (~6% relative), the same resolution the
percentiles already carry.

`GET /slo` on every `ServingServer` (and the `ServiceRegistry`) returns
`verdict()` as JSON; `scrape_cluster(slo=True)` pulls and merges them
fleet-wide.
"""
from __future__ import annotations

import threading
from bisect import bisect_right
from typing import NamedTuple, Optional

from ..reliability.metrics import (Histogram, histogram_bounds_ms,
                                   reliability_metrics)
from . import names as tnames

LATENCY = "latency"
ERROR_RATE = "error_rate"
GOODPUT = "goodput"
QUALITY = "quality"


class Objective(NamedTuple):
    """One declared objective. `kind` is `latency` (histogram `metric`,
    `quantile` of requests must finish under `threshold_ms`),
    `error_rate` (counter `metric` over counter `total_metric` must stay
    under `budget`), `goodput` (gauge `metric` must stay at or above
    `floor` — the training-side floor on productive wall-clock
    fraction), or `quality` (a model-quality gauge from
    telemetry/quality.py: a drift gauge bounded above by `ceiling`, or a
    streaming-eval metric bounded below by `floor`). `window_s` is the
    short evaluation window; a gauge objective reads the same last-set
    value in both windows (gauges carry no shards — the StepClock /
    quality sketches already window their own inputs)."""
    name: str
    kind: str
    metric: str
    window_s: float = 60.0
    threshold_ms: float = 0.0      # latency only
    quantile: float = 99.0         # latency only
    budget: float = 0.01           # error_rate only
    total_metric: str = ""         # error_rate only
    floor: float = 0.0             # goodput / quality metric floor
    ceiling: float = 0.0           # quality drift bound (value must stay <=)


def default_objectives() -> list:
    """The serving-tier defaults: e2e p99 under 250 ms over 60 s, and a
    1% budget on 5xx/shed responses. Replace with `configure()`."""
    return [
        Objective(name="serving.e2e.p99", kind=LATENCY,
                  metric=tnames.SERVING_REQUEST_E2E,
                  threshold_ms=250.0, quantile=99.0, window_s=60.0),
        Objective(name="serving.error_rate", kind=ERROR_RATE,
                  metric=tnames.SERVING_REQUEST_ERRORS,
                  total_metric=tnames.SERVING_REQUEST_TOTAL,
                  budget=0.01, window_s=60.0),
    ]


def trainer_objectives(goodput_floor: float = 0.9,
                       window_s: float = 60.0) -> list:
    """The training-tier default: goodput (productive/wall, the
    `train.goodput` gauge the StepClock publishes) must stay at or above
    `goodput_floor`. Trainers mount it with
    `configure(default_objectives() + trainer_objectives())` (the
    reference's `expose_trainer` is ROADMAP Queue 1 item 27)."""
    return [
        Objective(name="train.goodput.floor", kind=GOODPUT,
                  metric=tnames.TRAIN_GOODPUT, floor=goodput_floor,
                  window_s=window_s),
    ]


def quality_objectives(drift_ceiling: float = 0.25,
                       metric_floor: Optional[float] = None,
                       metric: str = "quality.eval.accuracy",
                       window_s: float = 60.0) -> list:
    """The model-quality objectives (telemetry/quality.py): the worst
    per-column PSI (`quality.drift.max`, refreshed on every scrape) must
    stay at or below `drift_ceiling` — 0.25 is the classic
    "distribution shifted" PSI bound — and, with `metric_floor` set, the
    streaming-eval gauge `metric` must stay at or above it. Ceiling
    objectives merge on the WORST (max) worker, floor objectives on the
    worst (min) — never averaged, like goodput."""
    out = [Objective(name="quality.drift", kind=QUALITY,
                     metric=tnames.QUALITY_DRIFT_MAX,
                     ceiling=drift_ceiling, window_s=window_s)]
    if metric_floor is not None:
        out.append(Objective(name="quality.metric.floor", kind=QUALITY,
                             metric=metric, floor=metric_floor,
                             window_s=window_s))
    return out


def canary_objectives(p99_ratio_max: float = 2.0,
                      error_burn_max: float = 1.0,
                      drift_delta_max: float = 0.25,
                      window_s: float = 60.0) -> list:
    """The canary objectives (telemetry/lineage.py): candidate-vs-
    incumbent ceilings over the scrape-refreshed canary gauges — the
    candidate's windowed p99 must stay under `p99_ratio_max` x the
    incumbent's frozen p99, its server-fault rate under `error_burn_max`
    x the canary error budget, and its live drift within
    `drift_delta_max` PSI of the incumbent's frozen drift. All three
    gauges are ABSENT until a hot-swap has produced an incumbent AND a
    candidate, and a no-data window burns 0 — a fleet that never swapped
    cannot trip its canary. This is the rollback *signal*; the actuation
    is `control.rollout.RolloutDriver`'s."""
    return [Objective(name="canary.p99", kind=QUALITY,
                      metric=tnames.CANARY_P99_RATIO,
                      ceiling=p99_ratio_max, window_s=window_s),
            Objective(name="canary.errors", kind=QUALITY,
                      metric=tnames.CANARY_ERROR_BURN,
                      ceiling=error_burn_max, window_s=window_s),
            Objective(name="canary.drift", kind=QUALITY,
                      metric=tnames.CANARY_DRIFT_DELTA,
                      ceiling=drift_delta_max, window_s=window_s)]


def _violations_over(counts: list, threshold_ms: float) -> int:
    """Observations in buckets strictly above the threshold's bucket —
    the merge-safe over-threshold count (threshold snaps DOWN to its
    bucket's upper edge, so this slightly undercounts rather than
    flapping the verdict on boundary noise)."""
    bounds = histogram_bounds_ms()
    idx = bisect_right(bounds, threshold_ms)
    return sum(counts[idx + 1:])


class SLOEngine:
    """Evaluates objectives against a registry's windowed shards and
    renders the machine-readable verdict `/slo` serves."""

    def __init__(self, objectives: Optional[list] = None, registry=None,
                 long_factor: float = 5.0):
        self.objectives = list(objectives if objectives is not None
                               else default_objectives())
        self._registry = (registry if registry is not None
                          else reliability_metrics)
        self.long_factor = float(long_factor)

    # -- per-window measurement ----------------------------------------------
    def _latency_window(self, obj: Objective, window_s: float) -> dict:
        # peek, never create: evaluating an SLO on a process that has
        # not recorded the metric (the registry leader, a fresh worker)
        # must not materialize zero-count serving series there
        hist = self._registry.peek_histogram(obj.metric)
        if hist is None or hist.window is None:
            return {"window_s": window_s, "count": 0, "violations": 0,
                    "no_window": True}
        state = hist.window.state(window_s)
        violations = _violations_over(state["counts"], obj.threshold_ms)
        value = (Histogram.from_state(obj.metric, state)
                 .percentile(obj.quantile) if state["count"] else 0.0)
        return {"window_s": window_s, "count": state["count"],
                "violations": violations, "value_ms": value}

    def _gauge_window(self, obj: Objective, window_s: float) -> dict:
        # a gauge is a last-set value, not a shard ring: both windows
        # read the same number (the StepClock's goodput is already a
        # cumulative-with-recent-median signal). peek, never create —
        # a never-trained process reads as no-data, not goodput 0.
        value = self._registry.peek_gauge(obj.metric)
        if value is None:
            return {"window_s": window_s, "no_data": True}
        return {"window_s": window_s, "value": float(value)}

    def _error_window(self, obj: Objective, window_s: float) -> dict:
        total = self._registry.peek_counter(obj.total_metric)
        if total is None or total.window is None:
            return {"window_s": window_s, "total": 0, "errors": 0,
                    "no_window": True}
        # an errors counter that was never created just means zero
        # errors so far — the denominator is still real traffic
        errors = self._registry.peek_counter(obj.metric)
        err_n = (errors.window.total(window_s)
                 if errors is not None and errors.window is not None
                 else 0)
        return {"window_s": window_s, "errors": err_n,
                "total": total.window.total(window_s)}

    def verdict(self, notify: bool = True) -> dict:
        """The per-worker SLO verdict: every objective with per-window
        counts (mergeable), rates, burn rates, and the ok/burning flags.
        `ok` is the short window within budget; `burning` is EVERY
        window over budget (sustained burn).

        Every evaluation notifies the flight recorder so an ok->burning
        TRANSITION dumps a debug bundle at the moment of distress;
        `notify=False` is for readers that must not re-trigger it (the
        recorder itself, capturing the verdict for its bundle)."""
        out = []
        for obj in self.objectives:
            windows = []
            for w in (obj.window_s, obj.window_s * self.long_factor):
                if obj.kind == LATENCY:
                    m = self._latency_window(obj, w)
                elif obj.kind in (GOODPUT, QUALITY):
                    m = self._gauge_window(obj, w)
                else:
                    m = self._error_window(obj, w)
                windows.append(_finish_window(obj._asdict(), m))
            burning = all(w["burn_rate"] > 1.0 for w in windows)
            out.append({"objective": obj._asdict(), "windows": windows,
                        "ok": windows[0]["burn_rate"] <= 1.0,
                        "burning": burning})
        result = {"objectives": out,
                  "ok": all(o["ok"] for o in out),
                  "burning": any(o["burning"] for o in out),
                  "workers": 1}
        if notify:
            # lazy and guarded: the verdict must render even if the
            # recorder (or its disk) is broken, and a disabled recorder
            # costs one attribute read
            try:
                from .perf import get_flight_recorder
                get_flight_recorder().on_verdict(result)
            except Exception:  # noqa: BLE001
                pass
        return result


def _finish_window(obj: dict, m: dict) -> dict:
    """Rate/burn math for one window measurement — shared by the live
    engine and the fleet merge so both always agree."""
    m = dict(m)
    if obj["kind"] in (GOODPUT, QUALITY):
        # gauge objectives: burn > 1 exactly when the gauge crosses its
        # bound — below the floor (goodput, a metric floor) or above the
        # ceiling (a drift bound). No data (never trained / no live
        # traffic folded) burns 0 — absence of evidence is not a burn
        value = m.get("value")
        floor = obj.get("floor", 0.0)
        ceiling = obj.get("ceiling", 0.0)
        if value is None:
            m["rate"], m["burn_rate"] = 0.0, 0.0
        else:
            m["rate"] = value
            if ceiling > 0:
                m["burn_rate"] = value / ceiling
            elif floor > 0:
                m["burn_rate"] = floor / max(value, 1e-9)
            else:
                m["burn_rate"] = 0.0
        return m
    if obj["kind"] == LATENCY:
        count, violations = m.get("count", 0), m.get("violations", 0)
        allowed = max(1.0 - obj["quantile"] / 100.0, 1e-9)
        rate = violations / count if count else 0.0
    else:
        count, violations = m.get("total", 0), m.get("errors", 0)
        allowed = max(obj["budget"], 1e-9)
        rate = violations / count if count else 0.0
    m["rate"] = rate
    m["burn_rate"] = rate / allowed
    return m


def verdict_burning(verdict: Optional[dict]) -> bool:
    """None-safe read of a verdict's fleet-level `burning` flag — the
    one-liner every actuator (burn-aware admission, the rollout driver)
    keys on. A missing/empty verdict reads NOT burning: actuation must
    fail open (keep serving) when the sensor is dark, never shed on a
    scrape gap."""
    return bool(verdict) and bool(verdict.get("burning"))


def merge_verdicts(verdicts: list) -> Optional[dict]:
    """Fleet-wide verdict from per-worker verdicts: per-objective,
    per-window counts SUM across workers and rates/burns are recomputed
    from the sums (a 2-worker fleet where one worker burns 2x and one 0x
    burns 1x overall — averaging the burn rates would say the same here
    but diverges the moment traffic is uneven). `value_ms` cannot be
    merged without buckets, so the merged view reports the worst worker
    as `value_ms_max` — labeled, not silently averaged."""
    verdicts = [v for v in verdicts if v]
    if not verdicts:
        return None
    by_name: dict = {}
    order: list = []
    for v in verdicts:
        for o in v.get("objectives", ()):
            name = o["objective"]["name"]
            agg = by_name.get(name)
            if agg is None:
                agg = by_name[name] = {
                    "objective": dict(o["objective"]),
                    "windows": [dict(w) for w in o["windows"]]}
                for w in agg["windows"]:
                    if "value_ms" in w:
                        w["value_ms_max"] = w.pop("value_ms")
                order.append(name)
                continue
            for wa, wb in zip(agg["windows"], o["windows"]):
                for key in ("count", "violations", "errors", "total"):
                    if key in wb:
                        wa[key] = wa.get(key, 0) + wb[key]
                if "value_ms" in wb:
                    wa["value_ms_max"] = max(wa.get("value_ms_max", 0.0),
                                             wb["value_ms"])
                if "value" in wb:
                    # gauge objectives: the WORST worker is the fleet
                    # verdict — min for a floor (goodput, metric floor),
                    # MAX for a ceiling (drift bound) — never averaged
                    pick = (max if agg["objective"].get("ceiling", 0.0) > 0
                            else min)
                    wa["value"] = (pick(wa["value"], wb["value"])
                                   if "value" in wa else wb["value"])
                    wa.pop("no_data", None)
    objectives = []
    for name in order:
        agg = by_name[name]
        windows = [_finish_window(agg["objective"], w)
                   for w in agg["windows"]]
        objectives.append({
            "objective": agg["objective"], "windows": windows,
            "ok": windows[0]["burn_rate"] <= 1.0,
            "burning": all(w["burn_rate"] > 1.0 for w in windows)})
    return {"objectives": objectives,
            "ok": all(o["ok"] for o in objectives),
            "burning": any(o["burning"] for o in objectives),
            "workers": sum(v.get("workers", 1) for v in verdicts)}


# Process-wide default engine (mirrors reliability_metrics / the default
# tracer): `/slo` mounts read it; `configure()` swaps the objectives.
_engine: Optional[SLOEngine] = None
_engine_lock = threading.Lock()


def get_engine() -> SLOEngine:
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = SLOEngine()
        return _engine


def configure(objectives: Optional[list] = None,
              long_factor: Optional[float] = None) -> SLOEngine:
    """Replace the process-default objectives (None restores defaults)."""
    global _engine
    with _engine_lock:
        current = _engine
        _engine = SLOEngine(
            objectives=objectives,
            long_factor=(long_factor if long_factor is not None
                         else (current.long_factor if current else 5.0)))
        return _engine
