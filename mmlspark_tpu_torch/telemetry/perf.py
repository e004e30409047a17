"""Plan-build telemetry of the serving path.

Port of the compile-log part of the reference's `telemetry/perf.py`
(`CompileLog` `:80`, `record_plan_compile` `:199`, `compile_stats`
`:213`), which imports no JAX. In the port a plan "compile" is a plan
build: for a host kernel (GBDT's `scoring_plan`) the closure's
construction, for a stage on the card the build plus its first forward at
that bucket, which creates the thread's cuBLAS/cuDNN handles and the
caching allocator's blocks (`io/plan.py`). Each build records a
`plan.compile` span and histogram, `plan.compiles`, and per-(fingerprint,
bucket) counts and seconds in a bounded LRU; a key built again is a
recompile (`plan.recompiles`), which steady-state serving keeps at zero.

The rest of the reference module (XLA cost and memory analysis, the
collective-traffic parse, `AotCache`, the resource gauges and the flight
recorder) is ROADMAP Queue 1 item 23: importing one of those names raises
NotImplementedError naming it.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Optional

from ..reliability.metrics import reliability_metrics
from . import names as tnames
from .spans import get_tracer, wall_now

# the reference module's names that belong to item 23
_ITEM_23 = ("executable_analysis", "compile_with_analysis",
            "collective_traffic", "COLLECTIVE_KINDS", "AotCache",
            "sample_resource_gauges", "FlightRecorder",
            "get_flight_recorder", "configure_flight_recorder",
            "hbm_utilization", "BUNDLE_DIR_ENV")


def __getattr__(name: str):
    if name in _ITEM_23:
        raise NotImplementedError(
            f"telemetry.perf.{name} is not ported yet (ROADMAP Queue 1 "
            f"item 23): the port's perf telemetry is the plan-build log")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# --------------------------------------------------------- compile telemetry
class CompileLog:
    """Bounded per-(fingerprint, shape-bucket) plan-build bookkeeping.

    `record()` is the single entry point: it feeds the aggregate
    `plan.compiles`/`plan.recompiles` counters and the `plan.compile`
    histogram on the given registry (mergeable fleet-wide: counters sum),
    emits a post-hoc `plan.compile` span (joins the ambient request trace
    when one is sampled), and keeps two bounded stores — an LRU map of
    per-key count/seconds and a deque of the most recent full records.
    A key seen again IS a recompile:
    either the plan cache evicted it (pressure) or shape bucketing
    failed (a bug the zero-recompile tests exist to catch)."""

    def __init__(self, max_keys: int = 512, max_records: int = 256,
                 registry=None, tracer=None):
        self._lock = threading.Lock()
        self._keys: OrderedDict = OrderedDict()
        self._records: deque = deque(maxlen=max(int(max_records), 1))
        self._max_keys = max(int(max_keys), 1)
        self._registry = registry
        self._tracer = tracer
        self._compiles = 0
        self._recompiles = 0
        self._seconds = 0.0

    def record(self, fingerprint, bucket, seconds: float,
               analysis: Optional[dict] = None,
               label: Optional[str] = None, registry=None,
               region: Optional[str] = None) -> dict:
        key = (str(fingerprint), bucket)
        if region is None:
            # a build inside a utils.tracing.annotate region tags itself
            # with it
            from ..utils.tracing import current_region
            region = current_region()
        with self._lock:
            ent = self._keys.get(key)
            recompile = ent is not None
            if ent is None:
                if len(self._keys) >= self._max_keys:
                    self._keys.popitem(last=False)
                ent = self._keys[key] = {"count": 0, "seconds": 0.0}
            else:
                self._keys.move_to_end(key)
            ent["count"] += 1
            ent["seconds"] += float(seconds)
            self._compiles += 1
            self._seconds += float(seconds)
            if recompile:
                self._recompiles += 1
            rec = {"fingerprint": str(fingerprint), "bucket": bucket,
                   "seconds": float(seconds), "count": ent["count"],
                   "recompile": recompile, "t": wall_now(),
                   "label": label, "region": region,
                   "analysis": analysis or None}
            self._records.append(rec)
        if registry is None:
            registry = self._registry
        reg = registry if registry is not None else reliability_metrics
        reg.inc(tnames.PLAN_COMPILES)
        if recompile:
            reg.inc(tnames.PLAN_RECOMPILES)
        reg.observe_ms(tnames.PLAN_COMPILE, float(seconds) * 1000.0)
        tracer = self._tracer if self._tracer is not None else get_tracer()
        tracer.record(tnames.PLAN_COMPILE_SPAN,
                      duration_ms=float(seconds) * 1000.0,
                      attrs={"fingerprint": str(fingerprint)[:16],
                             "bucket": str(bucket),
                             "recompile": recompile})
        return rec

    def per_key(self) -> dict:
        """{"<fingerprint>@<bucket>": {"count", "seconds"}}."""
        with self._lock:
            return {f"{fp}@{bucket}": dict(v)
                    for (fp, bucket), v in self._keys.items()}

    def records(self) -> list:
        """Most recent full records, oldest first (bounded)."""
        with self._lock:
            return list(self._records)

    def stats(self) -> dict:
        with self._lock:
            return {"compiles": self._compiles,
                    "recompiles": self._recompiles,
                    "seconds": self._seconds,
                    "keys": len(self._keys)}

    def clear(self) -> None:
        with self._lock:
            self._keys.clear()
            self._records.clear()
            self._compiles = 0
            self._recompiles = 0
            self._seconds = 0.0


_default_log = CompileLog()


def get_compile_log() -> CompileLog:
    return _default_log


def record_plan_compile(fingerprint, bucket, seconds: float,
                        analysis: Optional[dict] = None,
                        label: Optional[str] = None,
                        registry=None) -> dict:
    """Record one plan build into the process-default
    CompileLog (io/plan.py's builder calls this). `registry` routes the
    counters/histogram to a private registry (a ServingTransform built
    with `metrics=`); the recompile bookkeeping stays in the shared log
    either way."""
    return _default_log.record(fingerprint, bucket, seconds,
                               analysis=analysis, label=label,
                               registry=registry)


def compile_stats() -> dict:
    """Aggregate build counters of the process-default log."""
    return _default_log.stats()
