"""Telemetry of the port: request spans (`spans`), windowed metric views
(`window`), Prometheus/JSON exposition and the fleet scrape
(`exposition`), the plan-build log, first-call analysis, resource gauges
and flight recorder (`perf`), device-profile captures with per-region
kernel time and the roofline ledger (`profiler`), model versions, canary
comparisons and the fleet's rollout skew (`lineage`), the model quality
tap (`quality`: the fit-time profile and its serving half), the SLO
engine (`slo`: objectives, burn-rate verdicts and their fleet merge), the
live regression watcher (`watch`), and the training side's goodput clock
and straggler detector (`goodput`).

Ports of the reference's `telemetry/` modules, which import no JAX. The
reference's poller and trainer scrape surface (`poller.py`,
`ExpositionServer`, `expose_trainer`, which also serves the process
index of a multi-process trainer) are ROADMAP Queue 1 item 27: those
names raise NotImplementedError naming their item.
"""
from .goodput import PHASES, StepClock, StragglerDetector, peak_flops_from_env
from .spans import (CAPACITY_ENV, REQUEST_ID_HEADER, SAMPLE_ENV, Span,
                    SpanContext, TAIL_ENV, TRACE_HEADER, Tracer, configure,
                    get_tracer, head_sampled, new_id, parse_trace_header,
                    read_jsonl, wall_now)

# lazy: spans.py is the stdlib-only layer every subsystem imports, and
# that import runs this __init__
_LAZY_NAMES = {
    "PROM_CONTENT_TYPE": "exposition", "merge_states": "exposition",
    "metrics_http_response": "exposition",
    "render_prometheus": "exposition", "state_snapshot": "exposition",
    "scrape_cluster": "exposition", "ClusterSnapshot": "exposition",
    "WindowedCounter": "window", "WindowedHistogram": "window",
    "ModelVersion": "lineage", "RunLedger": "lineage",
    "model_version": "lineage", "configure_run_ledger": "lineage",
    "get_run_ledger": "lineage", "get_version_registry": "lineage",
    "reset_version_registry": "lineage", "export_versions": "lineage",
    "refresh_canary_gauges": "lineage",
    "merge_version_exports": "lineage", "rollout_skew": "lineage",
    "QualityMonitor": "quality", "DatasetProfile": "quality",
    "FeatureSketch": "quality", "StreamingEvaluator": "quality",
    "get_monitor": "quality", "reset_monitor": "quality",
    "configure_quality": "quality", "export_quality": "quality",
    "refresh_quality_gauges": "quality",
    "merge_quality_exports": "quality", "drift_scores": "quality",
    "psi": "quality", "js_divergence": "quality",
    "record_label": "quality",
    "CompileLog": "perf", "record_plan_compile": "perf",
    "get_compile_log": "perf", "compile_stats": "perf",
    "FlightRecorder": "perf", "AotCache": "perf",
    "collective_traffic": "perf", "compile_with_analysis": "perf",
    "executable_analysis": "perf", "hbm_utilization": "perf",
    "sample_resource_gauges": "perf", "sample_resource_stats": "perf",
    "get_flight_recorder": "perf", "configure_flight_recorder": "perf",
    "trigger_bundle": "perf",
    "ProfileSession": "profiler", "RooflineLedger": "profiler",
    "get_profile_session": "profiler",
    "configure_profile_session": "profiler",
    "capture_profile": "profiler", "parse_trace": "profiler",
    "get_roofline": "profiler", "resolve_peaks": "profiler",
    "flops_from_compile_log": "goodput",
    "Objective": "slo", "SLOEngine": "slo", "default_objectives": "slo",
    "merge_verdicts": "slo", "trainer_objectives": "slo",
    "quality_objectives": "slo", "canary_objectives": "slo",
    "verdict_burning": "slo",
    "WatchRule": "watch", "TelemetryWatcher": "watch",
    "evaluate_rule": "watch",
    "quality_watch_rules": "quality", "canary_watch_rules": "lineage",
}

# the reference's names not ported yet -> their ROADMAP Queue 1 item
_NOT_PORTED = {n: "27" for n in (
    "TelemetryPoller", "ExpositionServer", "expose_trainer")}


def __getattr__(name):
    mod = _LAZY_NAMES.get(name)
    if mod is not None:
        import importlib
        return getattr(importlib.import_module(f".{mod}", __name__), name)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"telemetry.{name} is not ported yet (ROADMAP Queue 1 item "
            f"{_NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["PHASES", "StepClock", "StragglerDetector", "peak_flops_from_env",
           "Tracer", "Span", "SpanContext", "get_tracer", "configure",
           "head_sampled", "new_id", "parse_trace_header", "read_jsonl",
           "wall_now", "TRACE_HEADER", "REQUEST_ID_HEADER", "SAMPLE_ENV",
           "CAPACITY_ENV", "TAIL_ENV", *_LAZY_NAMES]
