"""Metrics exposition: Prometheus text and a machine-mergeable JSON form.

Port of the serving half of the reference's `telemetry/exposition.py`
(which imports no JAX):

- `render_prometheus(registry)` — the Prometheus text format (0.0.4):
  counters as `<name>_total`, gauges plain, wall-clock timings as a
  `_seconds_total` / `_calls_total` pair, histograms with cumulative
  `_bucket{le="..."}` lines in seconds, windowed quantile gauges, and
  OpenMetrics exemplars on request. The same observations render the
  same text in either package.
- `metrics_http_response(path)` — the handler body of `ServingServer`'s
  exposition GETs (`/metrics`, `/metrics.json[?window=N]`, `/quality`,
  `/versions`). `/slo` needs `telemetry/slo.py` (ROADMAP Queue 1 item
  27), `/debug/bundle` and `/debug/profile` the flight recorder and the
  profile session (item 23): these answer 501 with a JSON error naming
  the item.
- `merge_states` / `state_snapshot` — the exact cross-process merge:
  counters and timings sum, histogram buckets sum elementwise and
  percentiles are recomputed from the merged buckets, never averaged.

- `scrape_cluster` / `ClusterSnapshot` — the fleet scrape over the
  service registry (`io.registry`): every worker's `/metrics.json`
  merged exactly, and on request its `/quality` and `/versions`.
  `slo=True` needs the SLO engine (item 27) and raises
  NotImplementedError naming it.

The trainer scrape surface (`ExpositionServer`, `expose_trainer`, which
mount the SLO engine) is item 27 and raises NotImplementedError naming
it.
"""
from __future__ import annotations

import json
import re
import urllib.parse
import urllib.request
from typing import NamedTuple, Optional

from ..reliability.metrics import (Histogram, histogram_bounds_ms,
                                   reliability_metrics)

# the exposition paths this port does not answer yet: path -> (item, what)
_NOT_PORTED = {"/slo": ("27", "telemetry/slo.py (the SLO engine)"),
               "/debug/bundle": ("23", "the flight recorder"),
               "/debug/profile": ("23", "the profile session")}

_LEFT_OUT = {"ExpositionServer": "27", "expose_trainer": "27"}


def __getattr__(name: str):
    if name in _LEFT_OUT:
        raise NotImplementedError(
            f"telemetry.exposition.{name} is not ported yet (ROADMAP Queue "
            f"1 item {_LEFT_OUT[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# exemplars are only legal in the OpenMetrics format — a 0.0.4 parser
# reads the trailing `# {...}` as a malformed timestamp and rejects the
# whole scrape — so /metrics?exemplars=1 switches format AND declares it
OPENMETRICS_CONTENT_TYPE = ("application/openmetrics-text; "
                            "version=1.0.0; charset=utf-8")

# windows rendered as Prometheus gauges on GET /metrics (seconds); the
# JSON form takes any ?window= the ring covers
PROM_WINDOWS_S = (60.0,)
_WINDOW_QUANTILES = ((50.0, "0.5"), (99.0, "0.99"), (99.9, "0.999"))

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str) -> str:
    """Sanitize a dotted metric name to the Prometheus grammar."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else f"{v:.9g}"


def render_prometheus(registry=None, state: Optional[dict] = None,
                      windows: Optional[tuple] = None,
                      exemplars: bool = False) -> str:
    """Render a registry (default: the process-wide `reliability_metrics`)
    or a raw `export_state()` dict as Prometheus text. `windows` selects
    the lookbacks for the windowed quantile gauges (default
    `PROM_WINDOWS_S`; only a live registry carries shards to render).
    `exemplars=True` appends OpenMetrics exemplar suffixes to histogram
    bucket lines — the caller must then serve the output under
    `OPENMETRICS_CONTENT_TYPE` with an `# EOF` trailer, never as 0.0.4
    (which cannot carry them)."""
    if state is None:
        reg = registry if registry is not None else reliability_metrics
        state = reg.export_state()
    bounds = histogram_bounds_ms()
    lines: list = []
    # OpenMetrics (the exemplar mode) names the FAMILY without the
    # `_total` suffix while the counter sample keeps it; 0.0.4 metadata
    # names the sample itself. Strict OM parsers reject the 0.0.4
    # spelling as a name clash, so the suffix placement follows the
    # negotiated format.
    om = exemplars
    for name in sorted(state.get("counters", {})):
        pn = prom_name(name)
        family = pn if om else pn + "_total"
        lines.append(f"# HELP {family} {name}")
        lines.append(f"# TYPE {family} counter")
        lines.append(f"{pn}_total {_fmt(state['counters'][name])}")
    for name in sorted(state.get("timings", {})):
        total, count = state["timings"][name]
        pn = prom_name(name)
        sfx = "" if om else "_total"
        lines.append(f"# HELP {pn}_seconds{sfx} {name} (wall-clock sink)")
        lines.append(f"# TYPE {pn}_seconds{sfx} counter")
        lines.append(f"{pn}_seconds_total {_fmt(total)}")
        lines.append(f"# TYPE {pn}_calls{sfx} counter")
        lines.append(f"{pn}_calls_total {_fmt(count)}")
    for name in sorted(state.get("gauges", {})):
        pn = prom_name(name)
        lines.append(f"# HELP {pn} {name}")
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {_fmt(state['gauges'][name])}")
    for name in sorted(state.get("hists", {})):
        h = state["hists"][name]
        pn = prom_name(name) + "_seconds"
        lines.append(f"# HELP {pn} {name} latency histogram")
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        counts = h["counts"]
        hist_ex = (h.get("exemplars") or {}) if exemplars else {}
        for i, bound_ms in enumerate(bounds):
            cum += counts[i]
            lines.append(f'{pn}_bucket{{le="{_fmt(bound_ms / 1000.0)}"}} '
                         f"{cum}" + _exemplar_suffix(hist_ex, i))
        lines.append(f'{pn}_bucket{{le="+Inf"}} {h["count"]}'
                     + _exemplar_suffix(hist_ex, len(bounds)))
        lines.append(f"{pn}_sum {_fmt(h['sum_ms'] / 1000.0)}")
        lines.append(f"{pn}_count {h['count']}")
    if registry is not None or state is None:
        reg = registry if registry is not None else reliability_metrics
        lines.extend(_render_window_gauges(
            reg, windows if windows is not None else PROM_WINDOWS_S))
    return "\n".join(lines) + "\n"


def _exemplar_suffix(exemplars: dict, idx: int) -> str:
    """OpenMetrics exemplar for one bucket line: the last trace id that
    landed in this bucket, with its value (seconds) and wall timestamp —
    `... # {trace_id="<id>"} 0.093 1723450000.1`. Empty when the bucket
    has none (exemplars are per-observation opt-in)."""
    ex = exemplars.get(str(idx))
    if ex is None:
        ex = exemplars.get(idx)
    if not ex:
        return ""
    trace_id, ms, ts = ex[0], float(ex[1]), float(ex[2])
    # the timestamp gets millisecond precision, NOT _fmt's 9 significant
    # digits — current epoch seconds would collapse to 10 s resolution
    # in exponent form, useless for ordering requests in a burn window
    return (f' # {{trace_id="{trace_id}"}} {_fmt(ms / 1000.0)}'
            f" {ts:.3f}")


def _render_window_gauges(reg, windows) -> list:
    """Windowed quantile gauges next to the cumulative series: one gauge
    family per histogram, labeled by window and quantile (plus the
    windowed count so rates are readable). Only rendered from a LIVE
    registry — a raw state dict carries no shards."""
    lines: list = []
    for window_s in windows:
        state = reg.window_state(window_s)
        win = _fmt(state["window_s"])
        for name in sorted(state.get("hists", {})):
            h = Histogram.from_state(name, state["hists"][name])
            pn = prom_name(name)
            lines.append(f"# HELP {pn}_window_seconds {name} windowed "
                         f"quantiles (last {win}s, shard-merged)")
            lines.append(f"# TYPE {pn}_window_seconds gauge")
            for q, label in _WINDOW_QUANTILES:
                lines.append(
                    f'{pn}_window_seconds{{window="{win}",'
                    f'quantile="{label}"}} '
                    f"{_fmt(h.percentile(q) / 1000.0)}")
            lines.append(f"# TYPE {pn}_window_count gauge")
            lines.append(f'{pn}_window_count{{window="{win}"}} '
                         f"{h.count}")
    return lines


def _wants_exemplars(path: str) -> bool:
    """?exemplars=1 (or any value but 0/false) on /metrics."""
    query = path.partition("?")[2]
    values = urllib.parse.parse_qs(query).get("exemplars")
    return bool(values) and values[-1].lower() not in ("0", "", "false")


def _parse_window(path: str):
    """(base_path, window_s | None) from a request path; raises
    ValueError on a malformed window so callers 400 instead of silently
    serving cumulative numbers to an autoscaler that asked for recent."""
    base, _, query = path.partition("?")
    values = urllib.parse.parse_qs(query).get("window")
    if not values:
        return base, None
    window_s = float(values[-1])
    # `not (> 0)` rather than `<= 0`: NaN fails both comparisons and must
    # land in the 400, not raise deep inside the shard merge
    if not (window_s > 0.0):
        raise ValueError(f"window must be > 0, got {window_s}")
    return base, window_s


def metrics_http_response(path: str, registry=None) -> tuple:
    """(status, payload_bytes, content_type) for the exposition GETs —
    `/metrics`, `/metrics.json[?window=N]`, `/quality`, `/versions` —
    the handler body `ServingServer` mounts on both transports. `/slo`,
    `/debug/bundle` and `/debug/profile` answer 501 with a JSON error
    naming the ROADMAP item that ports them."""
    reg = registry if registry is not None else reliability_metrics
    try:
        base, window_s = _parse_window(path)
    except ValueError as e:
        return 400, json.dumps({"error": str(e)}).encode(), \
            "application/json"
    if base in _NOT_PORTED:
        item, what = _NOT_PORTED[base]
        return 501, json.dumps(
            {"error": f"{base} needs {what}, not ported yet (ROADMAP "
                      f"Queue 1 item {item})"}).encode(), "application/json"
    if base in ("/metrics", "/metrics.json"):
        # model-quality gauges refresh right before any read that could
        # consume them: the drift gauges a /metrics scrape ships must
        # reflect the live sketches, not the last scrape. Guarded — a broken sketch loses drift
        # gauges, never the scrape; a process with no quality monitor
        # pays one None check.
        try:
            from .quality import refresh_quality_gauges
            refresh_quality_gauges(reg)
        except Exception:  # noqa: BLE001
            pass
        # canary gauges refresh on the same cadence: the candidate-vs-
        # incumbent comparison must reflect the splits as of THIS scrape.
        # Same guard.
        try:
            from .lineage import refresh_canary_gauges
            refresh_canary_gauges(reg)
        except Exception:  # noqa: BLE001
            pass
    if base == "/quality":
        from .quality import quality_http_response
        return quality_http_response()
    if base == "/versions":
        from .lineage import versions_http_response
        return versions_http_response(window_s=window_s)
    if base == "/metrics.json":
        return 200, \
            json.dumps(reg.export_state(window_s=window_s)).encode(), \
            "application/json"
    # /metrics honors ?window= too: it selects the windowed-gauge
    # lookback (the cumulative series are part of the Prometheus
    # contract and always render). ?exemplars=1 switches the response to
    # OpenMetrics (exemplar suffixes + # EOF trailer + its content
    # type); the default stays clean 0.0.4 so a stock Prometheus scrape
    # never sees a token it cannot parse.
    windows = (window_s,) if window_s is not None else None
    if _wants_exemplars(path):
        text = render_prometheus(reg, windows=windows, exemplars=True)
        return 200, (text + "# EOF\n").encode(), OPENMETRICS_CONTENT_TYPE
    return 200, render_prometheus(reg, windows=windows).encode(), \
        PROM_CONTENT_TYPE


# ---------------------------------------------------------------- merging
def merge_states(states: list) -> dict:
    """Merge raw `export_state()` dicts: counters/timings sum, histogram
    buckets sum elementwise, gauges keep max (see module docstring)."""
    merged = {"counters": {}, "timings": {}, "gauges": {}, "hists": {}}
    windows = [st["window_s"] for st in states if "window_s" in st]
    if windows:
        # a merged windowed state keeps the NARROWEST effective window —
        # the honest label when rings were configured unevenly
        merged["window_s"] = min(windows)
    for st in states:
        for name, v in st.get("counters", {}).items():
            merged["counters"][name] = merged["counters"].get(name, 0) + v
        for name, (total, count) in st.get("timings", {}).items():
            t = merged["timings"].setdefault(name, [0.0, 0])
            t[0] += total
            t[1] += count
        for name, v in st.get("gauges", {}).items():
            prev = merged["gauges"].get(name)
            merged["gauges"][name] = v if prev is None else max(prev, v)
        for name, h in st.get("hists", {}).items():
            m = merged["hists"].get(name)
            if m is None:
                merged["hists"][name] = m = {
                    "counts": list(h["counts"]), "count": h["count"],
                    "sum_ms": h["sum_ms"], "min_ms": h.get("min_ms"),
                    "max_ms": h.get("max_ms", 0.0)}
                ex = h.get("exemplars")
                if ex:
                    m["exemplars"] = dict(ex)
                continue
            m["counts"] = [a + b for a, b in zip(m["counts"], h["counts"])]
            m["count"] += h["count"]
            m["sum_ms"] += h["sum_ms"]
            mins = [x for x in (m.get("min_ms"), h.get("min_ms"))
                    if x is not None]
            m["min_ms"] = min(mins) if mins else None
            m["max_ms"] = max(m.get("max_ms", 0.0), h.get("max_ms", 0.0))
            for idx, ex in (h.get("exemplars") or {}).items():
                # newest exemplar per bucket wins across workers (an
                # exemplar is a pointer, not a statistic — no sum/avg
                # has meaning; recency keeps it actionable)
                dst = m.setdefault("exemplars", {})
                prev = dst.get(idx)
                if prev is None or float(ex[2]) >= float(prev[2]):
                    dst[idx] = list(ex)
    return merged


def state_snapshot(state: dict) -> dict:
    """Flatten a raw state into the same key shape
    `MetricsRegistry.snapshot()` produces — histogram percentiles are
    recomputed from the (possibly merged) bucket counts."""
    out = dict(state.get("counters", {}))
    for label, (total, count) in state.get("timings", {}).items():
        out[f"{label}.seconds"] = total
        out[f"{label}.count"] = count
    out.update(state.get("gauges", {}))
    for name, h in state.get("hists", {}).items():
        for k, v in Histogram.from_state(name, h).snapshot().items():
            out[f"{name}.{k}"] = v
    return out


class ClusterSnapshot(NamedTuple):
    """`scrape_cluster` result: the exactly-merged flat snapshot plus each
    worker's raw state for per-host drill-down. `slo` is the fleet-merged
    `/slo` verdict in the reference; here it is always None (the SLO
    engine is ROADMAP Queue 1 item 27). `quality` is the fleet-merged `/quality` export (sketch counts
    summed, drift recomputed from the merged counts) when
    ``quality=True`` was passed; `versions` is the fleet-merged
    `/versions` export (per-version splits summed, `current_by_worker`
    naming which worker serves which ModelVersion — the rollout-skew
    record) when ``versions=True`` was passed."""
    merged: dict
    workers: list   # [(ServiceInfo, raw state dict), ...]
    slo: Optional[dict] = None
    quality: Optional[dict] = None
    versions: Optional[dict] = None


def scrape_cluster(registry_address: str, name: Optional[str] = None,
                   timeout: float = 10.0,
                   skip_unreachable: bool = True,
                   window: Optional[float] = None,
                   slo: bool = False,
                   kind: Optional[str] = None,
                   quality: bool = False,
                   versions: bool = False) -> ClusterSnapshot:
    """Pull `/metrics.json` from every worker the `ServiceRegistry` at
    `registry_address` knows (optionally one service `name`) and merge.
    A worker that died between registering and the scrape is skipped (its
    numbers are gone either way); pass `skip_unreachable=False` to raise
    instead.

    `window` scrapes `/metrics.json?window=N` — the merged snapshot then
    covers only each worker's last N seconds (bucket counts still sum
    elementwise; percentiles recompute from the merged windowed buckets).
    `slo=True` needs the SLO engine (`telemetry/slo.py`, ROADMAP Queue 1
    item 27) and raises NotImplementedError naming it. `quality=True` also pulls each worker's `/quality` export and merges
    them with `telemetry.quality.merge_quality_exports` — live sketch
    counts sum exactly, fleet drift recomputes from the merged counts
    (never averaged from per-worker scores). `versions=True` also pulls
    each worker's `/versions` export and merges it with
    `telemetry.lineage.merge_version_exports` — per-version metric
    splits sum exactly, and the result's `current_by_worker` map records
    which worker serves which ModelVersion (the rollout-skew signal,
    `lineage.rollout_skew`). `kind` scrapes only services of that
    registry kind (``"serving"`` / ``"trainer"``) — no probing; the
    default merges
    both, which is well-defined because trainer gauges (goodput) keep
    max and step histograms bucket-sum exactly like every other
    metric."""
    if slo:
        raise NotImplementedError(
            "scrape_cluster(slo=True) merges the workers' /slo verdicts with "
            "telemetry/slo.py, not ported yet (ROADMAP Queue 1 item 27)")
    from ..io.registry import ServiceInfo, list_services
    if name is not None:
        infos = list_services(registry_address, name, timeout=timeout)
    else:
        with urllib.request.urlopen(registry_address + "/services",
                                    timeout=timeout) as resp:
            infos = [ServiceInfo(**d) for d in json.loads(resp.read())]
    if kind is not None:
        infos = [i for i in infos
                 if getattr(i, "kind", "serving") == kind]
    metrics_path = "/metrics.json"
    if window is not None:
        metrics_path += f"?window={float(window):g}"
    workers = []
    quality_exports = []
    version_exports = []
    for info in infos:
        try:
            with urllib.request.urlopen(info.address + metrics_path,
                                        timeout=timeout) as resp:
                state = json.loads(resp.read())
            if quality:
                # isolated: a worker without /quality (a pre-quality
                # version mid-rollout) keeps its metrics in the merge —
                # it just contributes no quality export
                try:
                    with urllib.request.urlopen(info.address + "/quality",
                                                timeout=timeout) as resp:
                        quality_exports.append(json.loads(resp.read()))
                except (OSError, ValueError):
                    pass
            if versions:
                # same isolation as /quality: a pre-versions worker
                # still merges its metrics
                try:
                    with urllib.request.urlopen(info.address + "/versions",
                                                timeout=timeout) as resp:
                        # keyed by address: unique per worker even when
                        # every partition registers the same service name
                        version_exports.append(
                            (info.address, json.loads(resp.read())))
                except (OSError, ValueError):
                    pass
            workers.append((info, state))
        except (OSError, ValueError) as e:
            if not skip_unreachable:
                raise RuntimeError(
                    f"scrape of {info.address} failed: {e}") from e
    merged_state = merge_states([st for _, st in workers])
    merged = state_snapshot(merged_state)
    merged["telemetry.scrape.workers"] = len(workers)
    if "window_s" in merged_state:
        merged["telemetry.scrape.window_s"] = merged_state["window_s"]
    merged_quality = None
    if quality:
        from .quality import merge_quality_exports
        try:
            merged_quality = merge_quality_exports(quality_exports)
        except Exception:  # noqa: BLE001 - the metrics merge stands
            merged_quality = None
    merged_versions = None
    if versions:
        from .lineage import merge_version_exports
        try:
            merged_versions = merge_version_exports(version_exports)
        except Exception:  # noqa: BLE001 - the metrics merge stands
            merged_versions = None
    return ClusterSnapshot(merged=merged, workers=workers, slo=None,
                           quality=merged_quality,
                           versions=merged_versions)
