"""Performance observability: the plan-build log, first-call analysis,
resource gauges and the burn-triggered flight recorder.

Port of the reference's `telemetry/perf.py` on PyTorch's own tools:

- **Compile log** (`CompileLog` / `record_plan_compile`): in the port a
  plan "compile" is a plan build: for a host kernel (GBDT's
  `scoring_plan`) the closure's construction, for a stage on the card the
  build plus its first forward at that bucket, which creates the
  thread's cuBLAS/cuDNN handles and the caching allocator's blocks
  (`io/plan.py`). Each build records a `plan.compile` span and histogram,
  `plan.compiles`, and per-(fingerprint, bucket) counts and seconds in a
  bounded LRU; a key built again is a recompile (`plan.recompiles`),
  which steady-state serving keeps at zero.
- **First-call analysis** (`executable_analysis` /
  `compile_with_analysis` / `AotCache`): torch has no ahead-of-time
  executable to ask, so the analysis comes from one run of the function,
  field by field, never raising and leaving a field ABSENT when it is
  unknown: `flops` from `torch.utils.flop_counter.FlopCounterMode` (it
  sees torch ops, not the port's ctypes kernels: a function made only of
  those has no `flops`), `peak_bytes` from the caching allocator's peak
  over the run (on the card), and `collectives` (`{kind: {ops, bytes}}`)
  from the run's `c10d` events under a host-only `torch.profiler` with
  `record_shapes` (`collective_traffic`), taken only in a process that
  joined a process group. `AotCache` keeps one entry per
  argument signature (shape, dtype, device): the first call per
  signature is timed and recorded with its analysis; later calls run the
  function as it is.
- **Resource gauges** (`sample_resource_gauges`): the caching allocator's
  bytes in use and peak (`torch.cuda.memory_stats`) and the card's free
  and total bytes (`torch.cuda.mem_get_info`) for every card the process
  has allocated on, plus the host RSS, into the reference's gauges,
  sampled on every metrics scrape. CUDA is only read when the process
  already initialized it: a scrape never pays a cold CUDA start.
- **Flight recorder** (`FlightRecorder`): when an SLO verdict
  TRANSITIONS to burning (or on demand via `GET /debug/bundle`), dump a
  bounded, rate-limited debug bundle (the reference's files and manifest
  keys: spans, pending tail traces, cumulative and windowed metrics, the
  SLO verdict, compile records, memory, goodput, roofline, quality,
  versions) to a directory. Disabled unless a bundle dir is configured
  (env ``MMLSPARK_TPU_BUNDLE_DIR`` or
  `configure_flight_recorder(bundle_dir=...)`).

`hbm_utilization` also lives here: achieved bytes/s over measured copy
bandwidth, computed the same way by every harness.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

from ..reliability.metrics import reliability_metrics
from . import names as tnames
from .spans import get_tracer, wall_now

BUNDLE_DIR_ENV = "MMLSPARK_TPU_BUNDLE_DIR"

_REASON_RE = re.compile(r"[^a-zA-Z0-9_-]+")


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
            # with it: the RooflineLedger's exact join key
            from .profiler import current_region
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
        colls = (analysis or {}).get("collectives") or {}
        if colls:
            # the collective account rides the fleet-mergeable counters
            # (sums across workers); per-kind detail stays on the record
            reg.inc(tnames.PLAN_COLLECTIVE_OPS,
                    sum(int(v.get("ops", 0)) for v in colls.values()))
            reg.inc(tnames.PLAN_COLLECTIVE_BYTES,
                    sum(int(v.get("bytes", 0)) for v in colls.values()))
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


# ------------------------------------------------------- collective traffic
COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "collective-permute", "all-to-all")

# torch's collective names (the `gloo:`/`nccl:` backend ranges, the
# `c10d::` ops) -> the reference's kinds; a broadcast keeps its own kind,
# point-to-point sends and receives are the permute's halves
_TORCH_COLLECTIVES = (
    ("reduce_scatter", "reduce-scatter"), ("allreduce", "all-reduce"),
    ("all_reduce", "all-reduce"), ("allgather", "all-gather"),
    ("all_gather", "all-gather"), ("alltoall", "all-to-all"),
    ("all_to_all", "all-to-all"), ("broadcast", "broadcast"),
    ("send", "collective-permute"), ("recv", "collective-permute"))

_DTYPE_BYTES = {"float": 4, "float32": 4, "double": 8, "float64": 8,
                "half": 2, "float16": 2, "bfloat16": 2, "c10::bfloat16": 2,
                "c10::half": 2, "long": 8, "long int": 8, "int64": 8,
                "int": 4, "int32": 4, "short": 2, "int16": 2, "char": 1,
                "signed char": 1, "int8": 1, "byte": 1, "unsigned char": 1,
                "uint8": 1, "bool": 1}


def _collective_kind(name: str) -> Optional[str]:
    low = name.lower()
    for token, kind in _TORCH_COLLECTIVES:
        if token in low:
            return kind
    return None


def _input_bytes(args: dict) -> int:
    """Bytes of a range's tensor inputs (`record_shapes` dims x dtype)."""
    total = 0
    for dims, dtype in zip(args.get("Input Dims") or [],
                           args.get("Input type") or []):
        size = _DTYPE_BYTES.get(str(dtype).lower(), 0)
        shapes = dims if dims and isinstance(dims[0], list) else [dims]
        for shape in shapes:
            n = 1
            for d in shape or []:
                n *= int(d)
            total += n * size if shape else 0
    return total


def collective_traffic(trace) -> dict:
    """Count collective ops and their payload bytes in a profiler capture:
    {kind: {"ops": n, "bytes": b}}. `trace` is a Chrome-trace dict
    (`export_chrome_trace`'s) or a finished `torch.profiler.profile` run
    with `record_shapes=True`. One op is one
    backend range (`gloo:all_reduce`, `nccl:all_reduce`, ...); its bytes
    are its input tensors' (per process: the payload each process hands
    the collective). A capture with no backend ranges falls back to the
    `c10d::` op events, counted without bytes."""
    if hasattr(trace, "export_chrome_trace"):
        import tempfile
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            trace.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else []
    out: dict = {}
    fallback: dict = {}
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        name = str(e.get("name", ""))
        args = e.get("args") if isinstance(e.get("args"), dict) else {}
        if name.startswith(("gloo:", "nccl:")):
            kind = _collective_kind(name.partition(":")[2])
            if kind is not None:
                ent = out.setdefault(kind, {"ops": 0, "bytes": 0})
                ent["ops"] += 1
                ent["bytes"] += _input_bytes(args)
        elif name.startswith("c10d::"):
            kind = _collective_kind(name[6:])
            if kind is not None:
                ent = fallback.setdefault(kind, {"ops": 0, "bytes": 0})
                ent["ops"] += 1
    return out or fallback


# ------------------------------------------------------ first-call analysis
def _run_analyzed(fn, args, kwargs, collectives: bool = True):
    """(fn's output, its analysis) from ONE run of `fn` (module
    docstring). The analysis never raises; fn's own exceptions do."""
    import contextlib

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    analysis: dict = {}
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    counter = FlopCounterMode(display=False)
    prof = None
    # collectives only exist in a process group: no group, no profiler
    collectives = (collectives and torch.distributed.is_available()
                   and torch.distributed.is_initialized())
    with contextlib.ExitStack() as stack:
        if collectives:
            # host activity only (no CUPTI start); a profiler already
            # running in the process leaves the field absent
            from .profiler import exclusive_profiler
            try:
                prof = stack.enter_context(exclusive_profiler(
                    activities=[torch.profiler.ProfilerActivity.CPU],
                    record_shapes=True))
            except Exception:  # noqa: BLE001 - busy: no collectives field
                prof = None
        stack.enter_context(counter)
        out = fn(*args, **kwargs)
    try:
        flops = counter.get_total_flops()
        if isinstance(flops, (int, float)) and flops > 0:
            analysis["flops"] = float(flops)
    except Exception:  # noqa: BLE001 - a field absent, never a raise
        pass
    if cuda:
        try:
            analysis["peak_bytes"] = float(torch.cuda.max_memory_allocated())
        except Exception:  # noqa: BLE001
            pass
    if prof is not None:
        try:
            traffic = collective_traffic(prof)
        except Exception:  # noqa: BLE001
            traffic = {}
        if traffic:
            analysis["collectives"] = traffic
    return out, analysis


def executable_analysis(fn, *args, collectives: bool = True,
                        **kwargs) -> dict:
    """The analysis of one run of `fn(*args, **kwargs)`: `flops`,
    `peak_bytes` and `collectives`, each present only when known (module
    docstring). NEVER raises, possibly returns {}: a function that fails
    has no analysis."""
    try:
        return _run_analyzed(fn, args, kwargs, collectives)[1]
    except Exception:  # noqa: BLE001 - the contract: never raise
        return {}


def _bucket_of(args) -> str:
    shapes = []
    for a in args:
        shape = getattr(a, "shape", None)
        shapes.append("x".join(str(d) for d in shape)
                      if shape is not None else type(a).__name__)
    return ",".join(shapes) or "scalar"


def compile_with_analysis(fn, *args, label: Optional[str] = None,
                          fingerprint: Optional[str] = None,
                          bucket=None, log: Optional[CompileLog] = None):
    """Run `fn(*args)` once, timing it and recording it with its analysis
    into the compile log; returns `fn` (callable with same-shaped args).
    The port's counterpart of the reference's jit -> lower -> compile: one
    call site gives a function a `plan.compile` span, per-(fingerprint,
    bucket) counters and its cost."""
    t0 = time.perf_counter()
    _, analysis = _run_analyzed(fn, args, {})
    seconds = time.perf_counter() - t0
    fp = fingerprint or label or getattr(fn, "__qualname__", None) or "fn"
    (log if log is not None else _default_log).record(
        fp, bucket if bucket is not None else _bucket_of(args), seconds,
        analysis=analysis, label=label or fp)
    return fn


class AotCache:
    """Per-signature first-call cache that records every first call.

    Wrapping a step function in an AotCache keeps ONE entry per argument
    signature (shape, dtype, device of each tensor): the first call per
    signature runs under the first-call analysis and is timed and recorded
    into the compile log with it; every later call runs the function as it
    is. A signature seen again after its entry was evicted (more than
    `max_entries` signatures) counts `plan.recompiles`, the same
    discipline as serving.

        step = AotCache(score_fn, label="workloads.sar.recommend")
        idx, vals = step(a, s_slices, pen)
    """

    def __init__(self, fn, label: str, fingerprint: Optional[str] = None,
                 log: Optional[CompileLog] = None, registry=None,
                 max_entries: int = 32):
        self._fn = fn
        self.label = label
        self.fingerprint = fingerprint or label
        self._log = log
        self._registry = registry
        self._max = max(int(max_entries), 1)
        self._lock = threading.Lock()
        self._seen: OrderedDict = OrderedDict()

    @property
    def fn(self):
        """The wrapped function."""
        return self._fn

    @staticmethod
    def _sig(args) -> tuple:
        sig = []
        for a in args:
            shape = getattr(a, "shape", None)
            if shape is None:
                sig.append(("py", type(a).__name__))
                continue
            sig.append((tuple(shape), str(getattr(a, "dtype", "?")),
                        str(getattr(a, "device", ""))))
        return tuple(sig)

    def __call__(self, *args):
        key = self._sig(args)
        with self._lock:
            seen = key in self._seen
            if seen:
                self._seen.move_to_end(key)
        if seen:
            return self._fn(*args)
        # the first call runs OUTSIDE the lock: two threads racing the
        # same key cost one duplicate record, never a serialized dispatch
        t0 = time.perf_counter()
        out, analysis = _run_analyzed(self._fn, args, {})
        seconds = time.perf_counter() - t0
        log = self._log if self._log is not None else _default_log
        log.record(self.fingerprint, _bucket_of(args), seconds,
                   analysis=analysis, label=self.label,
                   registry=self._registry)
        with self._lock:
            self._seen[key] = True
            while len(self._seen) > self._max:
                self._seen.popitem(last=False)
        return out


# -------------------------------------------------------------- bench math
def hbm_utilization(bytes_per_sec: float, copy_gbps: float) -> float:
    """Achieved memory traffic over MEASURED copy bandwidth (a throughput
    claim without it can hide a 50x memory-bound gap). 0.0 when bandwidth
    wasn't measured."""
    if copy_gbps is None or copy_gbps <= 0.0:
        return 0.0
    return float(bytes_per_sec) / (float(copy_gbps) * 1e9)


# ---------------------------------------------------------- resource gauges
def _host_rss_bytes() -> int:
    """Current resident set size: /proc on Linux, getrusage's peak as the
    portable fallback."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        try:
            import resource
            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:  # noqa: BLE001
            return 0


def _card_stats(ordinal: int) -> Optional[dict]:
    """One card's memory as the reference's `memory_stats()` keys, or None
    when the process never allocated on it."""
    import torch
    ms = torch.cuda.memory_stats(ordinal)
    if not ms:
        return None
    stats = {"bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
             "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
             "bytes_reserved": int(ms.get("reserved_bytes.all.current", 0)),
             "peak_bytes_reserved": int(ms.get("reserved_bytes.all.peak",
                                               0))}
    free, total = torch.cuda.mem_get_info(ordinal)
    stats["bytes_free"] = int(free)
    stats["bytes_limit"] = int(total)
    return stats


def sample_resource_stats() -> dict:
    """Raw device/host memory snapshot (what memory.json in a flight
    bundle holds): the host RSS and, for every card this process has
    allocated on, its allocator and free/total bytes. CUDA is only read
    when the process already initialized it (a scrape must never pay a
    cold CUDA start on the serving ingress thread); a card the allocator
    never used is left out."""
    out = {"t": wall_now(), "host_rss_bytes": _host_rss_bytes(),
           "devices": []}
    try:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                stats = _card_stats(i)
                if stats is not None:
                    out["devices"].append(
                        {"ordinal": i, "platform": "cuda",
                         "kind": torch.cuda.get_device_name(i),
                         "stats": stats})
    except Exception:  # noqa: BLE001 - a broken backend loses gauges,
        pass           # never a scrape
    return out


def sample_resource_gauges(registry=None) -> dict:
    """Sample device/host memory into gauges on `registry` (default: the
    process registry). Called on every exposition scrape, so
    `scrape_cluster` carries memory headroom next to latency; gauges merge
    with MAX across workers (worst headroom wins)."""
    reg = registry if registry is not None else reliability_metrics
    stats = sample_resource_stats()
    reg.set_gauge(tnames.HOST_RSS_BYTES, stats["host_rss_bytes"])
    total_use = 0.0
    total_peak = 0.0
    have = False
    for dev in stats["devices"]:
        ms = dev["stats"]
        if not ms:
            continue
        use = ms.get("bytes_in_use")
        peak = ms.get("peak_bytes_in_use")
        if isinstance(use, (int, float)):
            reg.set_gauge(tnames.device_mem_in_use(dev["ordinal"]), use)
            total_use += use
            have = True
        if isinstance(peak, (int, float)):
            reg.set_gauge(tnames.device_mem_peak(dev["ordinal"]), peak)
            total_peak += peak
            have = True
    if have:
        reg.set_gauge(tnames.DEVICE_MEM_BYTES_IN_USE, total_use)
        reg.set_gauge(tnames.DEVICE_MEM_PEAK_BYTES, total_peak)
    return stats


# ---------------------------------------------------------- flight recorder
class FlightRecorder:
    """Bounded, rate-limited debug-bundle dumper.

    Triggers: `SLOEngine.verdict()` notifies `on_verdict` — a verdict
    TRANSITIONING to burning dumps once (staying burning does not; the
    next transition re-arms after it clears); `GET /debug/bundle` calls
    `dump("on-demand")` directly. Both share one rate limit
    (`min_interval_s`, default 60 s) counted under
    `telemetry.bundle.suppressed`, and at most `max_bundles` bundle
    directories are kept (oldest pruned by mtime).

    The dump itself is synchronous and bounded — a span ring, pending
    tail traces, two metric snapshots, the verdict, recent compile
    records, a memory sample, the goodput clock, the roofline ledger, the
    quality and version exports; a few MB of local JSON, written with no
    lock held — simple enough to run from the /slo or /debug handler
    without a worker thread, so the burn->bundle path is deterministic
    under a seeded fault schedule. `profile_on_burn` also arms one
    profile capture (`telemetry.profiler`) on a burn that dumped.

    Disabled (every call a cheap no-op) until a bundle dir is set via
    env ``MMLSPARK_TPU_BUNDLE_DIR`` or `configure(bundle_dir=...)`."""

    def __init__(self, bundle_dir: Optional[str] = None,
                 min_interval_s: float = 60.0, max_bundles: int = 8,
                 window_s: float = 60.0, registry=None, tracer=None,
                 compile_log: Optional[CompileLog] = None,
                 profile_on_burn: bool = False):
        if bundle_dir is None:
            bundle_dir = os.environ.get(BUNDLE_DIR_ENV) or None
        self.bundle_dir = bundle_dir
        self.min_interval_s = float(min_interval_s)
        self.max_bundles = max(int(max_bundles), 1)
        self.window_s = float(window_s)
        # arm a device-profile capture on the same burn transition that
        # dumped the bundle (telemetry/profiler.py; a no-op until a
        # profile dir is configured, absorbed on failure — the bundle
        # outranks the profile)
        self.profile_on_burn = bool(profile_on_burn)
        self._registry = registry
        self._tracer = tracer
        self._compile_log = compile_log
        self._lock = threading.Lock()
        self._seq = 0
        self._last_dump: Optional[float] = None
        # per-trigger-source burn latches ("local" for the process SLO
        # engine, "fleet" for the poller's merged verdict): a burn is one
        # incident per source, and the sources must not mask each other
        self._burn_state: dict = {}

    @property
    def enabled(self) -> bool:
        return self.bundle_dir is not None

    def configure(self, bundle_dir=None, min_interval_s: Optional[float]
                  = None, max_bundles: Optional[int] = None,
                  window_s: Optional[float] = None,
                  profile_on_burn: Optional[bool] = None
                  ) -> "FlightRecorder":
        """Reconfigure in place (None leaves a knob untouched; pass
        bundle_dir="" to disable)."""
        with self._lock:
            if bundle_dir is not None:
                self.bundle_dir = bundle_dir or None
            if min_interval_s is not None:
                self.min_interval_s = float(min_interval_s)
            if max_bundles is not None:
                self.max_bundles = max(int(max_bundles), 1)
            if window_s is not None:
                self.window_s = float(window_s)
            if profile_on_burn is not None:
                self.profile_on_burn = bool(profile_on_burn)
        return self

    # -- triggers ------------------------------------------------------------
    def on_verdict(self, verdict: dict, reason: str = "slo-burn",
                   source: str = "local") -> Optional[dict]:
        """SLO hook: dump once per ok->burning transition, per trigger
        `source` (the process engine and the poller's fleet verdict each
        get their own latch). The latch only engages on a SUCCESSFUL
        dump — a transition whose dump was rate-limit-suppressed or
        failed is retried on the next burning verdict, so the one bundle
        the feature exists for is not silently lost to an earlier
        on-demand dump's rate-limit slot. Never raises."""
        if not self.enabled or not isinstance(verdict, dict):
            return None
        burning = bool(verdict.get("burning"))
        with self._lock:
            fire = burning and not self._burn_state.get(source, False)
            if not burning:
                self._burn_state[source] = False   # incident over: re-arm
        if not fire:
            return None
        manifest = None
        try:
            manifest = self.dump(reason, verdict=verdict)
        except Exception:  # noqa: BLE001 - verdict readers must survive
            manifest = None
        if manifest is not None:
            with self._lock:
                self._burn_state[source] = True
            if self.profile_on_burn:
                # the burn latch also arms ONE device-profile capture:
                # the bundle says WHAT burned, the profile says which op
                # burned it. Rate-limited by the profile session's own
                # slot; absorbed — the successful bundle already latched.
                try:
                    from .profiler import get_profile_session
                    get_profile_session().capture(reason=str(reason))
                except Exception:  # noqa: BLE001 - bundle outranks profile
                    pass
        return manifest

    # -- the dump ------------------------------------------------------------
    def dump(self, reason: str, verdict: Optional[dict] = None
             ) -> Optional[dict]:
        """Write one bundle; returns the manifest dict, or None when the
        recorder is disabled or the rate limit suppressed the dump.
        Raises on a failed write (OSError for an unwritable dir,
        TypeError for unserializable content) — with the rate-limit slot
        ROLLED BACK and the partial bundle dir removed, so a failed dump
        never shadows the next trigger for min_interval_s."""
        if not self.enabled:
            return None
        reg = self._registry if self._registry is not None \
            else reliability_metrics
        now = time.monotonic()
        with self._lock:
            if (self._last_dump is not None
                    and now - self._last_dump < self.min_interval_s):
                suppressed = True
            else:
                suppressed = False
                prev_last = self._last_dump
                self._last_dump = now
                seq = self._seq
                self._seq += 1
        if suppressed:
            reg.inc(tnames.TELEMETRY_BUNDLE_SUPPRESSED)
            return None
        # everything below runs with NO lock held: file I/O must never
        # serialize verdict evaluation or a second trigger's check
        tracer = self._tracer if self._tracer is not None else get_tracer()
        log = self._compile_log if self._compile_log is not None \
            else _default_log
        tag = _REASON_RE.sub("-", str(reason))[:48] or "bundle"
        path = os.path.join(self.bundle_dir,
                            f"bundle-{os.getpid()}-{seq:04d}-{tag}")
        if verdict is None:
            try:
                from .slo import get_engine
                # notify=False: capturing the verdict for the bundle must
                # not re-trigger the recorder mid-dump
                verdict = get_engine().verdict(notify=False)
            except Exception:  # noqa: BLE001 - bundle without a verdict
                verdict = None
        files = []

        def _jsonl(name: str, rows: list) -> None:
            with open(os.path.join(path, name), "w") as f:
                for row in rows:
                    f.write(json.dumps(row) + "\n")
            files.append(name)

        def _json(name: str, obj) -> None:
            with open(os.path.join(path, name), "w") as f:
                json.dump(obj, f, indent=1)
            files.append(name)

        try:
            os.makedirs(path, exist_ok=True)
            _jsonl("spans.jsonl", tracer.finished())
            _jsonl("pending.jsonl", tracer.pending_tail())
            _json("metrics.json", reg.export_state())
            _json("metrics_window.json",
                  reg.export_state(window_s=self.window_s))
            _json("slo.json", verdict)
            _json("compiles.json", {"stats": log.stats(),
                                    "per_key": log.per_key(),
                                    "records": log.records()})
            _json("memory.json", sample_resource_stats())
            # the training-side step-phase breakdown (empty {} on pure
            # serving processes): a burning TRAINING run's bundle then
            # says where its steps' time went
            from .goodput import default_snapshot
            _json("goodput.json", default_snapshot())
            # per-region roofline rows (telemetry/profiler.py): measured
            # region time joined with compile-log cost against peaks —
            # the bundle answers "where does the headroom live" per
            # kernel, not just whole-fit ({} until anything was noted)
            from .profiler import roofline_export
            _json("roofline.json", roofline_export())
            # model-quality state (telemetry/quality.py): per-feature
            # drift rows + streaming-eval state, so a burning bundle
            # says whether the fleet is also still PREDICTING well
            # ({"active": false} on processes without a reference)
            from .quality import export_quality
            _json("quality.json", export_quality())
            # deployment state (telemetry/lineage.py): which model
            # versions this process serves, their roles, per-version
            # metric splits, and the canary readout — a bundle tripped
            # by a canary watch rule NAMES the candidate it indicts
            # ({"versions": [], ...} on processes that never served)
            from .lineage import export_versions
            _json("versions.json", export_versions())
            manifest = {"reason": str(reason), "tag": tag, "seq": seq,
                        "pid": os.getpid(), "t": wall_now(), "path": path,
                        "files": files, "tracer": tracer.stats(),
                        "burning": (verdict or {}).get("burning")}
            _json("manifest.json", manifest)
        except Exception:
            # ANY failed dump — unwritable dir, a non-JSON-serializable
            # span attr or verdict value — gives the rate-limit slot back
            # (a failed dump must not shadow the next trigger) and clears
            # its partial bundle dir, then lets the caller report it
            # (on_verdict absorbs, /debug/bundle 500s)
            with self._lock:
                if self._last_dump == now:
                    self._last_dump = prev_last
            shutil.rmtree(path, ignore_errors=True)
            raise
        self._prune()
        reg.inc(tnames.TELEMETRY_BUNDLE_DUMPS)
        tracer.event(tnames.TELEMETRY_BUNDLE_EVENT, reason=str(reason),
                     path=path)
        return manifest

    def _prune(self) -> None:
        """Keep the newest `max_bundles` bundle dirs (mtime order);
        best-effort — a concurrent prune losing a race is harmless."""
        try:
            entries = [os.path.join(self.bundle_dir, e)
                       for e in os.listdir(self.bundle_dir)
                       if e.startswith("bundle-")]
            entries.sort(key=lambda p: (os.path.getmtime(p), p))
            for stale in entries[:-self.max_bundles]:
                shutil.rmtree(stale, ignore_errors=True)
        except OSError:
            pass


_recorder: Optional[FlightRecorder] = None
_recorder_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    global _recorder
    with _recorder_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
        return _recorder


def configure_flight_recorder(**kwargs) -> FlightRecorder:
    """Configure the process-default flight recorder (see
    `FlightRecorder.configure`)."""
    return get_flight_recorder().configure(**kwargs)


def trigger_bundle(reason: str, verdict: Optional[dict] = None
                   ) -> Optional[dict]:
    """Dump a bundle from the process-default recorder — the public
    one-liner for application code (`trigger_bundle("deploy-canary")`).
    Same contract as `FlightRecorder.dump`: None when disabled or
    rate-limited, OSError on an unwritable bundle dir."""
    return get_flight_recorder().dump(reason, verdict=verdict)
