"""Device-profile observability: triggered captures on `torch.profiler`,
their per-op parse with per-region kernel time, and the per-region
roofline ledger.

Port of the reference's `telemetry/profiler.py` (the same names, env
variables, counters and contracts):

- **ProfileSession**: programmatic `torch.profiler` capture (host and,
  with a card, CUDA activities) with the flight-recorder discipline:
  disabled until a profile dir is configured (env
  ``MMLSPARK_TPU_PROFILE_DIR``), min-interval rate limiting
  (`telemetry.profile.suppressed`), bounded retention (oldest capture
  dirs pruned), and failure ROLLBACK (a failed capture gives the
  rate-limit slot back and removes its partial dir). Triggers:
  `GET /debug/profile?ms=N`, a `StragglerDetector` flag on the flagged
  process, an SLO burn via the recorder latch
  (`FlightRecorder(profile_on_burn=True)`), and `utils.tracing.trace`.
  Only one `torch.profiler` may run in a process: every capture here, and
  every caller of `exclusive_profiler`, takes one process lock without
  waiting; a capture that finds it held is refused and counted under
  `telemetry.profile.busy` (a triggered capture answers as suppressed,
  an explicit one raises `ProfilerBusy`). A capture writes torch's Chrome
  trace (``<host>_<pid>.pt.trace.json``), the host intervals of the
  regions entered during it (``regions.json``) and the
  ``trace_context.json`` stamp into its dir.
- **parse_trace**: the capture parsed into per-op records
  ``{op, region, occurrences, self_time_us}`` from the DEVICE's kernel,
  memcpy and memset events, largest self time first, at most
  `_MAX_OP_RECORDS`. Never raises; with no device events (a CPU run) the
  table is empty, as the reference's is on its CPU backend. A device
  event's region is found by the CORRELATION ID of the call that launched
  it: CUPTI records every launch (`cudaLaunchKernel`, `cuLaunchKernel`,
  a copy) on the thread that made it, with a correlation id its kernel
  carries, so the region is the innermost registered region (`REGIONS`,
  and the port's own `PORT_REGIONS`)
  open on that thread at the launch: a `record_function` range of the
  capture, or, for threads the profiler does not follow (`record_function`
  is thread-local: serving's partition workers, a fit running beside a
  timed `capture`), the interval `utils.tracing.annotate` noted into
  ``regions.json``, moved onto the trace's clock by the marker ranges
  the session records when it starts (each bounds the offset between
  the two clocks by the host times either side of it; the parse takes
  the middle of what they all allow). A launch of a thread that opened
  no region in the capture, while the ranges other threads hold open at
  that moment all name one region, gets that region: the thread that
  waits (autograd's engine thread runs a step's backward while the
  step's thread waits in `backward()`). An event whose launch is not in
  the capture falls back to the device-side `gpu_user_annotation` range
  that contains it. Anything else is "other".
- **RooflineLedger**: joins per-region measured time (device self time
  when a parse provided it, the host wall `annotate` noted otherwise)
  with per-occurrence cost (`set_cost`, or the compile log's first-call
  analysis) into achieved FLOP/s and bytes/s against the peaks
  (`resolve_peaks`: explicit arguments, then env
  ``MMLSPARK_TPU_PEAK_TFLOPS`` / ``MMLSPARK_TPU_PEAK_HBM_GBPS``, then the
  chip table, which holds the H100 only). Exported as the
  `op.<region>.{hbm_util,flops_util}` gauges and the `roofline.json` of
  every flight bundle. A side that is unknown leaves its key ABSENT,
  never guessed.

A region adds no host synchronisation: its host wall on the card is
launch time, and the device time of a parse overrides it.
"""
from __future__ import annotations

import bisect
import contextlib
import contextvars
import glob
import gzip
import json
import logging
import os
import re
import shutil
import socket
import threading
import time
from typing import Optional

from ..reliability.metrics import reliability_metrics
from . import names as tnames
from .spans import get_tracer, wall_now

logger = logging.getLogger(__name__)

PROFILE_DIR_ENV = "MMLSPARK_TPU_PROFILE_DIR"
# default capture window for TRIGGERED captures (ms); explicit callers
# and ?ms=N override
PROFILE_MS_ENV = "MMLSPARK_TPU_PROFILE_MS"
PEAK_HBM_ENV = "MMLSPARK_TPU_PEAK_HBM_GBPS"

# Canonical region names: what the parser attributes per-op device time
# to, and the keys of the roofline ledger / the op.<region>.* gauges.
REGIONS = ("gbdt.hist", "gbdt.split", "gbdt.route",
           "serving.plan.run", "train.step")
# regions the port adds to the reference's: the image decoders' host and
# card halves
PORT_REGIONS = (tnames.IMAGE_DECODE_HOST, tnames.IMAGE_DECODE_CARD)

# per-card peaks (dense bf16 TFLOP/s, HBM GB/s) keyed on a substring of
# `torch.cuda.get_device_name`: the fallback when no env override is set.
# Spec-sheet numbers, labeled as such in resolve_peaks()["source"].
CHIP_PEAKS = (
    ("H100 80GB HBM3", 989.0, 3350.0),
)

_REASON_RE = re.compile(r"[^a-zA-Z0-9_-]+")

# the active region (utils.tracing.annotate sets it): CompileLog.record
# reads it so a build performed inside a region lands with an exact key
_region_var: contextvars.ContextVar = contextvars.ContextVar(
    "mmlspark_tpu_torch_region", default=None)


def current_region() -> Optional[str]:
    """The innermost active `utils.tracing.annotate` region, or None."""
    return _region_var.get()


# ---------------------------------------------------------------- peaks
def peak_hbm_from_env() -> Optional[float]:
    """Peak HBM bytes/s from ``MMLSPARK_TPU_PEAK_HBM_GBPS`` (GB/s), or
    None."""
    raw = os.environ.get(PEAK_HBM_ENV)
    if not raw:
        return None
    try:
        gbps = float(raw)
    except ValueError:
        return None
    return gbps * 1e9 if gbps > 0 else None


def _chip_peaks() -> Optional[tuple]:
    """(flops_per_s, hbm_bytes_per_s, name) of the current card, only
    when the process already initialized CUDA (a passive read never pays
    a cold CUDA start) and only for cards in CHIP_PEAKS."""
    try:
        import torch
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        name = torch.cuda.get_device_name(torch.cuda.current_device())
    except Exception:  # noqa: BLE001 - no card: no chip peaks
        return None
    for token, tflops, gbps in CHIP_PEAKS:
        if token.lower() in name.lower():
            return tflops * 1e12, gbps * 1e9, name
    return None


def resolve_peaks(peaks: Optional[dict] = None) -> dict:
    """{"flops_per_s", "hbm_bytes_per_s", "source"} with explicit args
    > env (``MMLSPARK_TPU_PEAK_TFLOPS`` / ``MMLSPARK_TPU_PEAK_HBM_GBPS``)
    > chip table. A side nobody declared stays None — downstream
    utilization gauges are then absent, never guessed."""
    out = {"flops_per_s": None, "hbm_bytes_per_s": None, "source": None}
    if peaks:
        out["flops_per_s"] = peaks.get("flops_per_s")
        out["hbm_bytes_per_s"] = peaks.get("hbm_bytes_per_s")
        out["source"] = peaks.get("source", "explicit")
        if (out["flops_per_s"] is not None
                and out["hbm_bytes_per_s"] is not None):
            return out
    from .goodput import peak_flops_from_env
    env_flops = peak_flops_from_env()
    env_hbm = peak_hbm_from_env()
    if out["flops_per_s"] is None and env_flops is not None:
        out["flops_per_s"] = env_flops
        out["source"] = out["source"] or "env"
    if out["hbm_bytes_per_s"] is None and env_hbm is not None:
        out["hbm_bytes_per_s"] = env_hbm
        out["source"] = out["source"] or "env"
    if out["flops_per_s"] is None or out["hbm_bytes_per_s"] is None:
        chip = _chip_peaks()
        if chip is not None:
            if out["flops_per_s"] is None:
                out["flops_per_s"] = chip[0]
            if out["hbm_bytes_per_s"] is None:
                out["hbm_bytes_per_s"] = chip[1]
            out["source"] = out["source"] or f"chip-table:{chip[2]}"
    return out


# ------------------------------------------- region intervals of a capture
# While a session captures, `annotate` notes each region's host interval
# here: the thread as the trace may name it (its native id for the thread
# that started the profiler; for the others the low 32 bits of its
# pthread id, which the trace writes as a signed 32-bit value's
# magnitude: 2^32 minus it past 2^31), start and end in time.time_ns(). The parse attributes the launches of threads the
# profiler does not follow with them.
_MAX_INTERVALS = 200_000
_intervals: list = []
_intervals_lock = threading.Lock()
_recording = False
_CLOCK_MARK = "mmlspark.profile.clock"
_CLOCK_MARKS = 4


def note_interval(name: str, t0_ns: int, t1_ns: int) -> None:
    """Note one region's host interval into the running capture (a no-op
    with none running)."""
    if not _recording or _region_of(name) is None:
        return
    with _intervals_lock:
        if len(_intervals) < _MAX_INTERVALS:
            _intervals.append((threading.get_native_id(),
                               threading.get_ident() & 0xFFFFFFFF,
                               int(t0_ns), int(t1_ns), name))


def _start_recording() -> None:
    global _recording
    with _intervals_lock:
        _intervals.clear()
        _recording = True


def _stop_recording() -> list:
    global _recording
    with _intervals_lock:
        _recording = False
        out = list(_intervals)
        _intervals.clear()
    return out


# ----------------------------------------------------------- trace parse
_MAX_OP_RECORDS = 512
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _trace_file(log_dir: str) -> Optional[str]:
    """The capture's newest torch Chrome trace under `log_dir`."""
    files = [p for p in glob.glob(os.path.join(log_dir, "*.pt.trace.json*"))
             if p.endswith((".json", ".json.gz"))]
    if not files:
        return None
    return max(files, key=lambda p: (os.path.getmtime(p), p))


def _region_of(name: str) -> Optional[str]:
    """The first registered region token in a range's name, or None."""
    for region in REGIONS + PORT_REGIONS:
        if region in name:
            return region
    return None


def _load_json(path: str):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


class _Timeline:
    """The (start, end, owner, region) ranges open at any moment: one
    sweep over their ends, then a bisect a query."""

    def __init__(self, ranges: list):
        self._ranges = ranges
        marks = sorted([(s, 1, i) for i, (s, _, _, _) in enumerate(ranges)]
                       + [(e, 0, i) for i, (_, e, _, _) in enumerate(ranges)])
        self._times: list = []
        self._open: list = []
        active: set = set()
        for t, starts, i in marks:
            (active.add if starts else active.discard)(i)
            if self._times and self._times[-1] == t:
                self._open[-1] = tuple(active)
            else:
                self._times.append(t)
                self._open.append(tuple(active))

    def open_at(self, ts: float) -> list:
        k = bisect.bisect_right(self._times, ts) - 1
        return [] if k < 0 else [self._ranges[i] for i in self._open[k]]

    def innermost(self, ts: float, owner) -> Optional[str]:
        """The region of `owner`'s innermost range open at `ts`: a
        thread's ranges nest, so the latest started (the shorter of two
        started together)."""
        mine = [r for r in self.open_at(ts) if r[2] == owner]
        return max(mine, key=lambda r: (r[0], -r[1]))[3] if mine else None


def _attributed(obj: dict, sidecar: Optional[dict]) -> tuple:
    """([(name, region, dur_us, ts_us)] of the device events, summary)."""
    events = obj.get("traceEvents") if isinstance(obj, dict) else None
    if not isinstance(events, list):
        return [], {}
    base_ns = obj.get("baseTimeNanoseconds", 0) or 0
    launches: dict = {}           # correlation -> (tid, ts)
    host_ranges: list = []        # (start, end, tid, region)
    traced_tids = set()           # threads whose ranges the trace holds
    device_ranges: list = []      # gpu_user_annotation (start, end, pid, r)
    device: list = []
    mark_ts: list = []
    for e in events:
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = e.get("ts"), e.get("dur")
        if not isinstance(ts, (int, float)):
            continue
        args = e.get("args") if isinstance(e.get("args"), dict) else {}
        name = str(e.get("name", ""))
        if cat in _DEVICE_CATS and isinstance(dur, (int, float)):
            device.append((name, args.get("correlation"), e.get("pid"),
                           float(ts), float(dur)))
        elif cat in _LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), float(ts))
        elif cat == "user_annotation":
            if name == _CLOCK_MARK:
                mark_ts.append(float(ts))
            region = _region_of(name)
            if region is not None and isinstance(dur, (int, float)):
                host_ranges.append((float(ts), float(ts) + float(dur),
                                    e.get("tid"), region))
                traced_tids.add(e.get("tid"))
        elif cat == "gpu_user_annotation" and isinstance(dur, (int, float)):
            region = _region_of(name)
            if region is not None:
                device_ranges.append((float(ts), float(ts) + float(dur),
                                      e.get("pid"), region))
    if sidecar:
        # the threads the profiler did not follow: their annotate
        # intervals, moved onto the trace's clock by the session's marker
        offset_ns = _clock_offset_ns(
            (sidecar.get("clock") or {}).get("marks", []), mark_ts, base_ns)
        for native, ident, t0, t1, name in sidecar.get("intervals", []):
            region = _region_of(str(name))
            if region is None:
                continue
            start = (t0 + offset_ns - base_ns) / 1000.0
            end = (t1 + offset_ns - base_ns) / 1000.0
            # a thread whose ranges the trace holds keeps them under its
            # native id; its launches may still carry its pthread id
            aliases = {ident} if ident < 1 << 31 else {
                ident, ident - (1 << 32), (1 << 32) - ident}
            if native not in traced_tids:
                aliases.add(native)
            for tid in aliases:
                host_ranges.append((start, end, tid, region))
    host, on_device = _Timeline(host_ranges), _Timeline(device_ranges)
    with_ranges = {r[2] for r in host_ranges}
    out = []
    counts = {"by_launch": 0, "by_waiting_thread": 0, "by_device_range": 0}
    for name, corr, pid, ts, dur in device:
        region = None
        launch = launches.get(corr) if corr is not None else None
        if launch is not None:
            tid, at = launch
            region = host.innermost(at, tid)
            if region is not None:
                counts["by_launch"] += 1
            elif tid not in with_ranges:
                held = {r[3] for r in host.open_at(at) if r[2] != tid}
                if len(held) == 1:
                    region = held.pop()
                    counts["by_waiting_thread"] += 1
        else:
            region = on_device.innermost(ts, pid)
            counts["by_device_range"] += region is not None
        out.append((name, region or "other", dur, ts))
    summary = {"device_events": len(device),
               "launches_found": sum(corr in launches
                                     for _, corr, _, _, _ in device),
               **counts,
               "busy_us": round(_union_us([(t, t + d)
                                           for _, _, _, t, d in device]), 3)}
    if device:
        summary["span_us"] = round(max(t + d for _, _, _, t, d in device)
                                   - min(t for _, _, _, t, _ in device), 3)
    return out, summary


def _union_us(intervals: list) -> float:
    total, end = 0.0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total


def _parse(log_dir: str) -> tuple:
    """(per-op records, device summary) of the capture in `log_dir`;
    never raises (a missing or torn file degrades to an empty table)."""
    path = _trace_file(log_dir)
    if path is None:
        return [], {}
    try:
        obj = _load_json(path)
    except Exception:  # noqa: BLE001 - a torn capture: no table
        return [], {}
    sidecar = None
    side = os.path.join(log_dir, "regions.json")
    if os.path.exists(side):
        try:
            sidecar = _load_json(side)
        except Exception:  # noqa: BLE001 - regions of other threads lost
            sidecar = None
    try:
        events, summary = _attributed(obj, sidecar)
    except Exception:  # noqa: BLE001 - an unexpected schema: no table
        return [], {}
    ops: dict = {}
    for name, region, dur, _ in events:
        ent = ops.get((name, region))
        if ent is None:
            ops[(name, region)] = ent = {"op": name, "region": region,
                                         "occurrences": 0,
                                         "self_time_us": 0.0}
        ent["occurrences"] += 1
        ent["self_time_us"] += dur
    records = sorted(ops.values(),
                     key=lambda r: (-r["self_time_us"], r["op"]))
    for r in records:
        r["self_time_us"] = round(r["self_time_us"], 3)
    return records[:_MAX_OP_RECORDS], summary


def parse_trace(log_dir: str) -> list:
    """Per-op records of a capture's DEVICE events: ``[{op, region,
    occurrences, self_time_us}]``, largest self time first, bounded.
    NEVER raises; a CPU capture (no device events) gives []."""
    return _parse(log_dir)[0]


def region_totals(records: list) -> dict:
    """{region: {"self_time_us", "occurrences"}} rollup of a per-op
    table (what the ledger ingests after a capture)."""
    out: dict = {}
    for r in records:
        ent = out.setdefault(r.get("region", "other"),
                             {"self_time_us": 0.0, "occurrences": 0})
        ent["self_time_us"] += float(r.get("self_time_us", 0.0))
        ent["occurrences"] += int(r.get("occurrences", 0))
    return out


# -------------------------------------------------------- roofline ledger
class RooflineLedger:
    """Per-region achieved-vs-peak accounting (module docstring).

    Two measurement sources feed it: `note_region` (host wall from
    `utils.tracing.annotate`, on every backend) and `ingest_ops` (device
    self time from a parsed capture, which overrides the host wall for
    the regions it covers, labeled ``source: device``). Costs join per
    region from the compile log (records whose ``region`` tag or label
    matches) or explicitly via `set_cost`. All state is bounded: regions
    are a handful of names, ops keep the last parse only."""

    def __init__(self, registry=None, compile_log=None,
                 peaks: Optional[dict] = None):
        self._registry = registry
        self._compile_log = compile_log
        self._peaks = peaks
        self._lock = threading.Lock()
        self._host: dict = {}     # region -> [seconds, occurrences, source]
        self._device: dict = {}   # region -> {"self_time_us", "occurrences"}
        self._ops: list = []      # last parsed per-op table (bounded)
        self._costs: dict = {}    # region -> {"flops", "bytes_accessed"}

    # -- measurement feeds ---------------------------------------------------
    def note_region(self, region: str, seconds: float,
                    occurrences: int = 1, source: str = "host") -> None:
        """Accumulate wall-clock region time measured OUTSIDE a device
        trace. `source` labels its provenance; device self time from a
        parse overrides these rows entirely."""
        s = max(float(seconds), 0.0)
        with self._lock:
            ent = self._host.setdefault(region, [0.0, 0, str(source)])
            ent[0] += s
            ent[1] += int(occurrences)
            ent[2] = str(source)

    def ingest_ops(self, records: list) -> None:
        """Adopt a parsed per-op table: device region totals REPLACE
        earlier device totals (a capture is a fresh window, not a
        cumulative series)."""
        totals = region_totals(records)
        totals.pop("other", None)
        with self._lock:
            self._ops = list(records)
            if totals:
                self._device = totals

    def set_cost(self, region: str, flops: Optional[float] = None,
                 bytes_accessed: Optional[float] = None) -> None:
        """Declare a region's PER-OCCURRENCE cost explicitly. None leaves
        that side unknown."""
        with self._lock:
            ent = self._costs.setdefault(region, {})
            if flops is not None:
                ent["flops"] = float(flops)
            if bytes_accessed is not None:
                ent["bytes_accessed"] = float(bytes_accessed)

    def clear(self) -> None:
        with self._lock:
            self._host.clear()
            self._device.clear()
            self._costs.clear()
            self._ops = []

    # -- the join ------------------------------------------------------------
    def _cost_of(self, region: str) -> Optional[dict]:
        # explicit declarations win; else the newest compile record
        # tagged with (or labeled as) the region — an exact join key
        cost = self._costs.get(region)
        if cost:
            return dict(cost)
        log = self._compile_log
        if log is None:
            from .perf import get_compile_log
            log = get_compile_log()
        for rec in reversed(log.records()):
            if rec.get("region") != region and rec.get("label") != region:
                continue
            analysis = rec.get("analysis") or {}
            out = {}
            for field in ("flops", "bytes_accessed"):
                v = analysis.get(field)
                if isinstance(v, (int, float)) and v > 0:
                    out[field] = float(v)
            if out:
                return out
        return None

    def rows(self, peaks: Optional[dict] = None) -> dict:
        """{region: row} with measured seconds/occurrences (+source),
        per-occurrence cost when known, achieved FLOP/s and bytes/s, and
        utilizations when the matching peak is known. Absent keys ARE the
        degrade — a consumer must not find a guessed 0.0."""
        resolved = resolve_peaks(peaks if peaks is not None else self._peaks)
        with self._lock:
            host = {k: list(v) for k, v in self._host.items()}
            device = {k: dict(v) for k, v in self._device.items()}
            costs_known = set(self._costs)
        out: dict = {}
        for region in sorted(set(host) | set(device) | costs_known):
            if region in device:
                seconds = device[region]["self_time_us"] / 1e6
                occurrences = device[region]["occurrences"]
                source = "device"
            elif region in host:
                seconds, occurrences, source = host[region]
            else:
                continue   # a cost with no measurement yet: nothing to say
            row = {"seconds": round(seconds, 6),
                   "occurrences": int(occurrences), "source": source}
            cost = self._cost_of(region)
            if cost and seconds > 0.0:
                for field, achieved_key, peak_key, util_key in (
                        ("flops", "achieved_flops_per_s", "flops_per_s",
                         "flops_util"),
                        ("bytes_accessed", "achieved_hbm_bytes_per_s",
                         "hbm_bytes_per_s", "hbm_util")):
                    per_occ = cost.get(field)
                    if per_occ is None:
                        continue
                    row[field] = per_occ
                    achieved = per_occ * occurrences / seconds
                    row[achieved_key] = round(achieved, 1)
                    peak = resolved.get(peak_key)
                    if peak:
                        # 9 decimals: a genuinely tiny utilization must
                        # not round to a 0.0 that reads as guessed
                        row[util_key] = round(achieved / peak, 9)
            out[region] = row
        return out

    def publish(self, registry=None) -> dict:
        """Set the `op.<region>.{hbm_util,flops_util}` gauges for every
        region whose utilization is computable; absent sides set
        nothing. Returns the rows it published from."""
        reg = registry if registry is not None else (
            self._registry if self._registry is not None
            else reliability_metrics)
        rows = self.rows()
        for region, row in rows.items():
            if "hbm_util" in row:
                reg.set_gauge(tnames.op_hbm_util(region), row["hbm_util"])
            if "flops_util" in row:
                reg.set_gauge(tnames.op_flops_util(region),
                              row["flops_util"])
        return rows

    def export(self) -> dict:
        """The roofline.json body: peaks (with provenance), per-region
        rows, and the last parsed per-op table."""
        with self._lock:
            ops = list(self._ops)
        return {"t": wall_now(),
                "peaks": resolve_peaks(self._peaks),
                "regions": self.rows(),
                "ops": ops}


_default_ledger = RooflineLedger()


def get_roofline() -> RooflineLedger:
    return _default_ledger


def note_region(region: str, seconds: float) -> None:
    """Host-wall region note into the process-default ledger
    (`utils.tracing.annotate` calls this on every region exit)."""
    _default_ledger.note_region(region, seconds)


@contextlib.contextmanager
def region(name: str):
    """Activate `name` as the current region for the block (build records
    made inside tag themselves with it): the contextvar half of
    `utils.tracing.annotate`."""
    token = _region_var.set(name)
    try:
        yield
    finally:
        _region_var.reset(token)


def roofline_export() -> dict:
    """The default ledger's export — what FlightRecorder.dump writes as
    roofline.json. Never raises (a bundle without roofline beats no
    bundle)."""
    try:
        return _default_ledger.export()
    except Exception:  # noqa: BLE001
        return {}


def _stamp_context(log_dir: str, ctx, registry=None) -> bool:
    """Stamp a profile dir with the active trace id
    (`trace_context.json`) so the artifact and the span log
    cross-reference each other; a failed stamp is counted under
    `telemetry.profile.stamp_errors`."""
    reg = registry if registry is not None else reliability_metrics
    try:
        with open(os.path.join(log_dir, "trace_context.json"), "w") as f:
            json.dump({"trace_id": ctx.trace_id,
                       "span_id": ctx.span_id}, f)
        return True
    except OSError:
        reg.inc(tnames.TELEMETRY_PROFILE_STAMP_ERRORS)
        return False


# ------------------------------------------------ one profiler per process
class ProfilerBusy(RuntimeError):
    """Another `torch.profiler` capture of this process is running."""


_profiler_lock = threading.Lock()


def _acquire_profiler(registry=None) -> bool:
    if _profiler_lock.acquire(blocking=False):
        return True
    (registry if registry is not None else reliability_metrics).inc(
        tnames.TELEMETRY_PROFILE_BUSY)
    return False


@contextlib.contextmanager
def exclusive_profiler(**kwargs):
    """`torch.profiler.profile(**kwargs)` under the process's one-profiler
    lock, taken without waiting: raises `ProfilerBusy` (counted under
    `telemetry.profile.busy`) while a session or another caller holds
    it. For callers that want torch's own tables."""
    if not _acquire_profiler():
        raise ProfilerBusy("another torch.profiler capture is running in "
                           "this process")
    try:
        import torch
        with torch.profiler.profile(**kwargs) as prof:
            yield prof
    finally:
        _profiler_lock.release()


def _activities() -> list:
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _clock_mark() -> dict:
    """Marker ranges on the profiled thread, each with time.time_ns()
    on either side: the parse's offset between the trace's clock and the
    intervals `annotate` notes."""
    import torch
    marks = []
    for _ in range(_CLOCK_MARKS):
        t0 = time.time_ns()
        with torch.profiler.record_function(_CLOCK_MARK):
            pass
        marks.append((t0, time.time_ns()))
    return {"marks": marks}


def _clock_offset_ns(marks: list, mark_ts: list, base_ns: float) -> float:
    """Trace clock minus host clock: a marker stamped at trace time T
    between host times t0 and t1 allows offsets in [T - t1, T - t0]; the
    middle of what every marker allows (of the tightest marker's, should
    they disagree), 0 with no marker."""
    bounds = [(base_ns + ts * 1000.0 - t1, base_ns + ts * 1000.0 - t0)
              for (t0, t1), ts in zip(marks, sorted(mark_ts))]
    if not bounds:
        return 0.0
    lo, hi = max(b[0] for b in bounds), min(b[1] for b in bounds)
    if lo > hi:
        lo, hi = min(bounds, key=lambda b: b[1] - b[0])
    return 0.5 * (lo + hi)


# ---------------------------------------------------- the Perfetto link
# How long `serve_perfetto_link` waits for the trace to be fetched.
PERFETTO_TIMEOUT_S = 120.0


def serve_perfetto_link(path: str, timeout_s: Optional[float] = None
                        ) -> dict:
    """Serve the trace file `path` on a localhost port, log the
    ``ui.perfetto.dev`` link that opens it, and return once the trace
    has been fetched or `timeout_s` (default `PERFETTO_TIMEOUT_S`,
    120 s) has passed: {"link", "fetched"}. The browser on this machine
    fetches the trace; nothing is sent anywhere."""
    from http.server import BaseHTTPRequestHandler, HTTPServer

    timeout_s = PERFETTO_TIMEOUT_S if timeout_s is None else timeout_s
    name = os.path.basename(path)
    state = {"fetched": False}

    class _Trace(BaseHTTPRequestHandler):
        def _cors(self):
            self.send_header("Access-Control-Allow-Origin",
                             "https://ui.perfetto.dev")

        def do_OPTIONS(self):  # noqa: N802 (stdlib naming)
            self.send_response(200)
            self._cors()
            self.send_header("Access-Control-Allow-Methods", "GET")
            self.end_headers()

        def do_GET(self):  # noqa: N802
            if self.path.lstrip("/").split("?")[0] != name:
                self.send_response(404)
                self.end_headers()
                return
            with open(path, "rb") as f:
                body = f.read()
            self.send_response(200)
            self._cors()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            state["fetched"] = True

        def log_message(self, *args):  # quiet
            pass

    httpd = HTTPServer(("127.0.0.1", 0), _Trace)
    httpd.timeout = 0.1
    port = httpd.server_address[1]
    link = (f"https://ui.perfetto.dev/#!/?url=http://127.0.0.1:{port}/"
            f"{name}")
    logger.warning("open the profile in Perfetto: %s", link)
    deadline = time.monotonic() + float(timeout_s)
    try:
        while not state["fetched"] and time.monotonic() < deadline:
            httpd.handle_request()
    finally:
        httpd.server_close()
    return {"link": link, "fetched": state["fetched"]}


# --------------------------------------------------------- ProfileSession
class ProfileSession:
    """Rate-limited, bounded, rollback-safe device-profile capture
    (module docstring). Disabled (every trigger a cheap no-op / 503)
    until a profile dir is configured via env ``MMLSPARK_TPU_PROFILE_DIR``
    or `configure(profile_dir=...)`; `utils.tracing.trace` passes an
    explicit log_dir + force=True and works regardless."""

    def __init__(self, profile_dir: Optional[str] = None,
                 min_interval_s: float = 60.0, max_profiles: int = 4,
                 max_ms: float = 10_000.0, registry=None, tracer=None,
                 ledger: Optional[RooflineLedger] = None):
        if profile_dir is None:
            profile_dir = os.environ.get(PROFILE_DIR_ENV) or None
        self.profile_dir = profile_dir
        self.min_interval_s = float(min_interval_s)
        self.max_profiles = max(int(max_profiles), 1)
        self.max_ms = float(max_ms)
        self._registry = registry
        self._tracer = tracer
        self._ledger = ledger
        self._lock = threading.Lock()
        self._seq = 0
        self._last: Optional[float] = None

    @property
    def enabled(self) -> bool:
        return self.profile_dir is not None

    def configure(self, profile_dir=None,
                  min_interval_s: Optional[float] = None,
                  max_profiles: Optional[int] = None,
                  max_ms: Optional[float] = None) -> "ProfileSession":
        """Reconfigure in place (None leaves a knob untouched; pass
        profile_dir="" to disable)."""
        with self._lock:
            if profile_dir is not None:
                self.profile_dir = profile_dir or None
            if min_interval_s is not None:
                self.min_interval_s = float(min_interval_s)
            if max_profiles is not None:
                self.max_profiles = max(int(max_profiles), 1)
            if max_ms is not None:
                self.max_ms = float(max_ms)
        return self

    def default_ms(self) -> float:
        """Capture window for triggered captures (straggler flags, burn
        latches): env ``MMLSPARK_TPU_PROFILE_MS``, default 200, clamped
        to max_ms."""
        raw = os.environ.get(PROFILE_MS_ENV)
        try:
            ms = float(raw) if raw else 200.0
        except ValueError:
            ms = 200.0
        return min(max(ms, 1.0), self.max_ms)

    # -- the capture primitive -----------------------------------------------
    @contextlib.contextmanager
    def session(self, reason: str = "trace",
                log_dir: Optional[str] = None, force: bool = False,
                create_perfetto_link: bool = False):
        """Capture a device profile around the enclosed block; yields an
        info dict that gains ``ops``/``regions``/``device``/``path`` at
        exit.

        One capture path for every entry point: rate-limit gate (skipped
        with force=True), the one-profiler lock, `device.profile` span,
        the trace-context stamp, per-op parse, ledger feed, retention
        pruning. A suppressed capture (rate limit, or the profiler busy)
        yields ``{"suppressed": True}`` and runs the block unprofiled; a
        forced one finding the profiler busy raises `ProfilerBusy`; a
        FAILED capture rolls the rate-limit slot back, removes the
        partial capture dir (never a caller-owned log_dir), and raises.
        `create_perfetto_link` serves the written trace to
        ui.perfetto.dev over localhost (`serve_perfetto_link`) before
        returning."""
        reg = self._registry if self._registry is not None \
            else reliability_metrics
        own_dir = log_dir is None
        if own_dir and not self.enabled:
            raise RuntimeError(
                "ProfileSession disabled — set MMLSPARK_TPU_PROFILE_DIR "
                "or configure(profile_dir=...)")
        now = time.monotonic()
        with self._lock:
            if (not force and self._last is not None
                    and now - self._last < self.min_interval_s):
                suppressed = True
                prev_last = seq = None
            else:
                suppressed = False
                prev_last = self._last
                self._last = now
                seq = self._seq
                self._seq += 1
        if suppressed:
            reg.inc(tnames.TELEMETRY_PROFILE_SUPPRESSED)
            yield {"suppressed": True}
            return
        if not _acquire_profiler(reg):
            with self._lock:
                if self._last == now:
                    self._last = prev_last
            if force:
                raise ProfilerBusy("another torch.profiler capture is "
                                   "running in this process")
            yield {"suppressed": True, "busy": True}
            return
        try:
            with self._capture(reason, log_dir, own_dir, seq, now,
                               prev_last, reg) as info:
                yield info
        finally:
            _profiler_lock.release()
        if create_perfetto_link:
            info["perfetto"] = serve_perfetto_link(info["trace"])

    @contextlib.contextmanager
    def _capture(self, reason, log_dir, own_dir, seq, now, prev_last, reg):
        tag = _REASON_RE.sub("-", str(reason))[:48] or "profile"
        if own_dir:
            log_dir = os.path.join(self.profile_dir,
                                   f"profile-{os.getpid()}-{seq:04d}-{tag}")
        tracer = self._tracer if self._tracer is not None else get_tracer()
        info = {"path": log_dir, "reason": str(reason), "tag": tag,
                "t": wall_now()}
        prof = None
        span = None

        def _rollback():
            # a failed capture must not shadow the next trigger for
            # min_interval_s, keep a partial dir in the retention budget,
            # or leak an unfinished span
            if span is not None:
                span.finish(error="capture-failed")
            with self._lock:
                if self._last == now:
                    self._last = prev_last
            if own_dir:
                shutil.rmtree(log_dir, ignore_errors=True)

        try:
            import torch
            os.makedirs(log_dir, exist_ok=True)
            span = tracer.start_span(tnames.DEVICE_PROFILE_SPAN,
                                     attrs={"log_dir": log_dir})
            prof = torch.profiler.profile(activities=_activities())
            prof.start()
            clock = _clock_mark()
            _start_recording()
            yield info
        except BaseException:
            if prof is not None:
                _stop_recording()
                try:
                    prof.stop()
                except Exception:  # noqa: BLE001 - already torn down
                    pass
            _rollback()
            raise
        try:
            intervals = _stop_recording()
            prof.stop()
            trace = os.path.join(
                log_dir, f"{socket.gethostname()}_{os.getpid()}"
                         f".pt.trace.json")
            prof.export_chrome_trace(trace)
            with open(os.path.join(log_dir, "regions.json"), "w") as f:
                json.dump({"clock": clock, "intervals": intervals}, f)
            ctx = span.context if span is not None else tracer.current()
            if ctx is not None:
                _stamp_context(log_dir, ctx, reg)
            ops, summary = _parse(log_dir)
            info["trace"] = trace
            info["ops"] = ops
            info["regions"] = region_totals(ops)
            info["device"] = summary
            ledger = self._ledger if self._ledger is not None \
                else _default_ledger
            ledger.ingest_ops(ops)
            ledger.publish(registry=reg)
        except BaseException:
            _rollback()
            raise
        if span is not None:
            span.finish(ops=len(ops))
        if own_dir:
            self._prune()
        reg.inc(tnames.TELEMETRY_PROFILE_CAPTURES)
        tracer.event(tnames.TELEMETRY_PROFILE_EVENT, reason=str(reason),
                     path=log_dir, ops=len(ops))

    def capture(self, ms: Optional[float] = None,
                reason: str = "on-demand",
                force: bool = False) -> Optional[dict]:
        """Timed capture: profile for `ms` (clamped to max_ms) and return
        the manifest, or None when the rate limit (or a running capture)
        suppressed it. /debug/profile maps None to 429, disabled to 503,
        and a raised failure to 500."""
        if not self.enabled:
            return None
        if ms is None:
            ms = self.default_ms()
        ms = min(max(float(ms), 1.0), self.max_ms)
        with self.session(reason=reason, force=force) as info:
            if info.get("suppressed"):
                return None
            time.sleep(ms / 1000.0)
        info["ms"] = ms
        return info

    def _prune(self) -> None:
        """Keep the newest `max_profiles` capture dirs (mtime order);
        best-effort — losing a race to a concurrent prune is harmless."""
        try:
            entries = [os.path.join(self.profile_dir, e)
                       for e in os.listdir(self.profile_dir)
                       if e.startswith("profile-")]
            entries.sort(key=lambda p: (os.path.getmtime(p), p))
            for stale in entries[:-self.max_profiles]:
                shutil.rmtree(stale, ignore_errors=True)
        except OSError:
            pass


_session: Optional[ProfileSession] = None
_session_lock = threading.Lock()


def get_profile_session() -> ProfileSession:
    global _session
    with _session_lock:
        if _session is None:
            _session = ProfileSession()
        return _session


def configure_profile_session(**kwargs) -> ProfileSession:
    """Configure the process-default profile session (see
    `ProfileSession.configure`)."""
    return get_profile_session().configure(**kwargs)


def capture_profile(ms: Optional[float] = None, reason: str = "manual",
                    force: bool = False) -> Optional[dict]:
    """One-liner timed capture on the process-default session (the
    public application API; triggers use the same path)."""
    return get_profile_session().capture(ms=ms, reason=reason, force=force)
