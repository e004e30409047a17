"""Deployment observability: content-addressed model versions, the run
ledger, per-version telemetry splits and canary comparisons.

Port of the reference's `telemetry/lineage.py` (which imports no JAX):

- **ModelVersion** — a content-addressed identity: the structural
  fingerprint the plan cache keys on (the port's own
  `io.plan.pipeline_fingerprint`), extended with a fitted-array content
  digest so two fits of one architecture are different versions, and a
  lineage record the GBDT estimators stamp at fit time. The fingerprint
  hashes the stage's module name, so the port's and the reference's
  digests of the same model differ by design.
- **RunLedger** — an append-only JSONL of every fitted version (env
  `MMLSPARK_TPU_RUN_LEDGER` or `configure_run_ledger(path)`).
- **VersionRegistry** — the process-level registry
  `ServingTransform.install_model` feeds, bounded to two slots
  (incumbent and candidate), each with its own `MetricsRegistry`, so
  `/versions` answers per-version splits.
- **Fleet merge** — `merge_version_exports` merges the workers'
  `/versions` exports (per-version splits summed exactly, which worker
  serves which version) and `rollout_skew` counts workers per version.
- **Canary gauges** — `refresh_canary_gauges` publishes
  `canary.p99.ratio` / `canary.error_burn` / `canary.drift.delta`,
  comparing the candidate's live telemetry with the incumbent's frozen
  baseline; `canary_watch_rules` watches them (`telemetry/watch.py`),
  as the rollout driver does.

Everything here is guarded the same way the quality tier is: lineage
must never fail a fit, and version accounting must never fail a request.
"""
from __future__ import annotations

import json
import os
import threading
from typing import NamedTuple, Optional

from ..reliability.metrics import MetricsRegistry, reliability_metrics
from . import names as tnames
from .spans import wall_now

# keep bounded: incumbent + candidate only; a
# longer history is the RunLedger's job, not the live registry's
MAX_VERSION_SLOTS = 2

# candidate error-budget for canary.error_burn (fraction of requests
# allowed to fail server-side before the gauge reads 1.0 == burning)
DEFAULT_CANARY_ERROR_BUDGET = 0.01


class ModelVersion(NamedTuple):
    """Content-addressed model identity + its fit-time lineage record."""
    version: str                    # short id clients see (X-Model-Version)
    fingerprint: str                # structural digest (plan-cache keys)
    content_digest: Optional[str]   # fitted-array content digest (opt-in)
    lineage: dict                   # JSON-safe fit-time record

    def export(self) -> dict:
        return {"version": self.version, "fingerprint": self.fingerprint,
                "content_digest": self.content_digest,
                "lineage": dict(self.lineage)}


def model_version(model, content: bool = True,
                  lineage: Optional[dict] = None) -> ModelVersion:
    """Build the ModelVersion for a fitted model/pipeline.

    `content=True` (default) hashes the fitted arrays' BYTES, so two
    fits of the same architecture on different data are distinct
    versions — the identity `install_model` swaps on and every reply's
    `X-Model-Version` names. `content=False` falls back to the cheap
    structural digest (identical-architecture fits collide — fine for
    tests that only need A-vs-B). The lineage record the estimators
    stamped on the model (`model.lineage`) rides along; an explicit
    `lineage=` overrides it."""
    from ..io.plan import pipeline_fingerprint   # lazy: io imports telemetry
    fp = pipeline_fingerprint(model)
    digest = pipeline_fingerprint(model, content=True) if content else None
    rec = lineage if lineage is not None else \
        dict(getattr(model, "lineage", None) or {})
    return ModelVersion(version=(digest or fp)[:12], fingerprint=fp,
                        content_digest=digest, lineage=rec)


# ------------------------------------------------------------ run ledger
class RunLedger:
    """Append-only JSONL of fitted model versions: one line per fit,
    written whole (single os.write of one encoded line) so concurrent
    fitters interleave at line granularity, never mid-record."""

    def __init__(self, path: str):
        self.path = path

    def append(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True,
                          default=str).encode() + b"\n"
        fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                     0o644)
        try:
            os.write(fd, line)
        finally:
            os.close(fd)

    def append_event(self, event: str, **attrs) -> dict:
        """Journal one named control-plane event (rollout transitions,
        promotions, rollbacks) with a wall-clock stamp. File order IS the
        sequence — append is a single O_APPEND write, so a reader can pin
        `deploy < burn < rollback < recovered` by line position alone."""
        record = {"event": event, "t": wall_now(), **attrs}
        self.append(record)
        return record

    def records(self) -> list:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue   # torn tail line (crashed writer): skip
        return out


_ledger: Optional[RunLedger] = None
_ledger_lock = threading.Lock()


def configure_run_ledger(path: Optional[str]) -> Optional[RunLedger]:
    """Set (or clear, with None) the process run ledger."""
    global _ledger
    with _ledger_lock:
        _ledger = RunLedger(path) if path else None
        return _ledger


def get_run_ledger() -> Optional[RunLedger]:
    """The configured ledger, else one from MMLSPARK_TPU_RUN_LEDGER."""
    with _ledger_lock:
        if _ledger is not None:
            return _ledger
    path = os.environ.get("MMLSPARK_TPU_RUN_LEDGER")
    return RunLedger(path) if path else None


# ------------------------------------------------- the version registry
class _Slot:
    """One tracked version: its identity, its own metrics registry (the
    per-version latency/error split), and — once superseded — the frozen
    baseline the canary gauges compare the candidate against."""

    __slots__ = ("mv", "role", "installed_at", "registry", "frozen")

    def __init__(self, mv: ModelVersion):
        self.mv = mv
        self.role = "candidate"
        self.installed_at = wall_now()
        self.registry = MetricsRegistry()
        self.frozen: Optional[dict] = None

    def baseline(self) -> dict:
        """Snapshot this slot's own stats (taken at swap time to freeze
        the incumbent's baseline)."""
        snap = self.registry.snapshot()
        total = snap.get(tnames.SERVING_REQUEST_TOTAL, 0)
        errors = snap.get(tnames.SERVING_REQUEST_ERRORS, 0)
        return {
            "p99_ms": snap.get(tnames.SERVING_REQUEST_TRANSFORM + ".p99"),
            "p50_ms": snap.get(tnames.SERVING_REQUEST_TRANSFORM + ".p50"),
            "requests": total, "errors": errors,
            "error_rate": (errors / total) if total else 0.0,
            "drift_max": _live_drift_max(),
        }


def _live_drift_max() -> Optional[float]:
    """Current quality.drift scores' max from the live monitor — read
    directly (not via gauges) so freezing works without a scrape."""
    try:
        from . import quality as tquality
        drift = tquality.get_monitor().drift()
        vals = [row.get("psi") for row in drift.values()
                if isinstance(row, dict)]
        vals = [v for v in vals if v is not None]
        return max(vals) if vals else None
    except Exception:  # noqa: BLE001 - lineage never fails serving
        return None


class VersionRegistry:
    """Process-level registry of the served model versions (bounded:
    incumbent + candidate). `ServingTransform` installs versions and
    feeds per-request observations; `/versions` exports it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots: "list[_Slot]" = []   # [incumbent?, candidate]

    # -- install / swap ---------------------------------------------------
    def install(self, mv: ModelVersion, metrics=None) -> dict:
        """Track `mv` as the served (candidate) version. The previously
        current slot becomes the incumbent and its stats freeze — the
        canary baseline. Returns {"old": id|None, "new": id}."""
        reg = metrics if metrics is not None else reliability_metrics
        with self._lock:
            cur = self._slots[-1] if self._slots else None
            if cur is not None and cur.mv.version == mv.version:
                return {"old": cur.mv.version, "new": mv.version}
            if cur is not None:
                cur.role = "incumbent"
                cur.frozen = cur.baseline()
            self._slots.append(_Slot(mv))
            del self._slots[:-MAX_VERSION_SLOTS]
            n = len(self._slots)
        reg.set_gauge(tnames.SERVING_MODEL_VERSION_INFO, float(n))
        return {"old": cur.mv.version if cur else None, "new": mv.version}

    def _slot(self, version_id: Optional[str]) -> Optional[_Slot]:
        for s in self._slots:
            if version_id is None or s.mv.version == version_id:
                if version_id is not None or s is self._slots[-1]:
                    return s
        return None

    # -- per-request observation -----------------------------------------
    def observe(self, version_id: str, ms: Optional[float] = None,
                rows: int = 1, errors: int = 0) -> None:
        """Fold one served batch into that version's split registry.
        Unknown versions (a drained plan finishing after its slot aged
        out) are dropped — bounded by design, never raising."""
        with self._lock:
            slot = self._slot(version_id)
        if slot is None:
            return
        if rows:
            slot.registry.inc(tnames.SERVING_REQUEST_TOTAL, rows)
        if errors:
            slot.registry.inc(tnames.SERVING_REQUEST_ERRORS, errors)
        if ms is not None:
            slot.registry.observe_ms(tnames.SERVING_REQUEST_TRANSFORM, ms)

    def current_version(self) -> Optional[str]:
        with self._lock:
            return self._slots[-1].mv.version if self._slots else None

    # -- export / canary --------------------------------------------------
    def export(self, window_s: Optional[float] = None) -> dict:
        """JSON-safe `/versions` payload: every tracked version's
        lineage, role, per-version metric split, and (incumbent) frozen
        baseline, plus the live canary comparison when both exist."""
        with self._lock:
            slots = list(self._slots)
        versions = {}
        for s in slots:
            entry = s.mv.export()
            entry["role"] = s.role
            entry["installed_at"] = s.installed_at
            try:
                entry["metrics"] = s.registry.export_state(
                    window_s=window_s)
            except ValueError:
                entry["metrics"] = s.registry.export_state()
            entry["split"] = s.baseline() if s.frozen is None else None
            entry["frozen"] = s.frozen
            versions[s.mv.version] = entry
        out = {"current": slots[-1].mv.version if slots else None,
               "versions": versions}
        canary = self._canary_values(slots)
        if canary:
            out["canary"] = canary
        return out

    def _canary_values(self, slots,
                       error_budget: float = DEFAULT_CANARY_ERROR_BUDGET
                       ) -> Optional[dict]:
        """Candidate-vs-incumbent comparison, None until a swap has
        produced both a frozen baseline and a live candidate."""
        if len(slots) < 2 or slots[0].frozen is None:
            return None
        cand, base = slots[-1].baseline(), slots[0].frozen
        out: dict = {"candidate": slots[-1].mv.version,
                     "incumbent": slots[0].mv.version}
        if cand["p99_ms"] is not None and base.get("p99_ms"):
            out["p99_ratio"] = cand["p99_ms"] / base["p99_ms"]
        out["error_burn"] = cand["error_rate"] / max(error_budget, 1e-9)
        if cand["drift_max"] is not None:
            out["drift_delta"] = cand["drift_max"] - (
                base.get("drift_max") or 0.0)
        return out

    def refresh_canary_gauges(self, registry=None,
                              error_budget: float =
                              DEFAULT_CANARY_ERROR_BUDGET) -> dict:
        """Publish the canary comparison as gauges (scrape-time refresh,
        like the quality gauges). Gauges stay ABSENT until incumbent +
        candidate both exist: the SLO engine reads absence as no_data,
        burn 0 — a fleet that never swapped can't burn a canary."""
        reg = registry if registry is not None else reliability_metrics
        with self._lock:
            slots = list(self._slots)
        vals = self._canary_values(slots, error_budget=error_budget)
        if not vals:
            return {}
        if "p99_ratio" in vals:
            reg.set_gauge(tnames.CANARY_P99_RATIO, vals["p99_ratio"])
        reg.set_gauge(tnames.CANARY_ERROR_BURN, vals["error_burn"])
        if "drift_delta" in vals:
            reg.set_gauge(tnames.CANARY_DRIFT_DELTA, vals["drift_delta"])
        return vals

    def reset(self) -> None:
        with self._lock:
            self._slots = []


_registry: Optional[VersionRegistry] = None
_registry_lock = threading.Lock()


def get_version_registry() -> VersionRegistry:
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = VersionRegistry()
        return _registry


def reset_version_registry() -> None:
    global _registry
    with _registry_lock:
        _registry = None


# ------------------------------------------------------- module helpers
def export_versions(window_s: Optional[float] = None) -> dict:
    """The process's `/versions` payload (flight bundles embed it as
    versions.json)."""
    return get_version_registry().export(window_s=window_s)


def refresh_canary_gauges(registry=None) -> dict:
    """Scrape-time canary gauge refresh (exposition calls this next to
    the quality refresh; guarded there)."""
    return get_version_registry().refresh_canary_gauges(registry=registry)


def versions_http_response(window_s: Optional[float] = None):
    """(status, body, content_type) for GET /versions."""
    return 200, json.dumps(export_versions(window_s=window_s),
                           default=str).encode(), "application/json"


def merge_version_exports(exports: list) -> dict:
    """Merge per-worker `/versions` payloads fleet-wide: version ids
    union (lineage from any worker — content addressing makes them
    identical), per-version metric splits merge EXACTLY via the same
    `merge_states` discipline the cluster scrape uses (counts sum,
    histogram buckets add), and each version remembers which workers
    currently serve it — the rollout-skew record the poller tracks."""
    from .exposition import merge_states
    merged: dict = {"versions": {}, "current_by_worker": {}}
    states: dict = {}
    workers: dict = {}
    for name, exp in exports:
        if not isinstance(exp, dict):
            continue
        merged["current_by_worker"][name] = exp.get("current")
        for vid, entry in (exp.get("versions") or {}).items():
            tgt = merged["versions"].setdefault(
                vid, {k: v for k, v in entry.items() if k != "metrics"})
            states.setdefault(vid, []).append(entry.get("metrics") or {})
            workers.setdefault(vid, []).append(name)
            # a version incumbent on one worker and candidate on another
            # is MID-ROLLOUT; candidate (the newer role) wins the merge
            if entry.get("role") == "candidate":
                tgt["role"] = "candidate"
    for vid, sts in states.items():
        try:
            merged["versions"][vid]["metrics"] = merge_states(sts)
        except Exception:  # noqa: BLE001 - a torn worker export can't
            merged["versions"][vid]["metrics"] = {}      # kill the merge
        merged["versions"][vid]["workers"] = sorted(workers[vid])
    return merged


def rollout_skew(current_by_worker: dict) -> dict:
    """Per-version worker counts from a merged export's
    `current_by_worker` map — `{version_id: n_workers}`; more than one
    key means the fleet is mid-rollout (the poller's skew series)."""
    skew: dict = {}
    for ver in current_by_worker.values():
        if ver is not None:
            skew[ver] = skew.get(ver, 0) + 1
    return skew


def canary_watch_rules(p99_ratio_max: float = 2.0,
                       error_burn_max: float = 1.0,
                       drift_delta_max: float = 0.25) -> list:
    """Watch rules over the canary gauges: a candidate 2x slower than
    the incumbent's frozen p99, burning its error budget, or drifting
    past the PSI delta trips the watcher (flight bundle + event) —
    min_samples=1 because each sample is already a full fleet scrape."""
    from .watch import WatchRule
    return [WatchRule(key=tnames.CANARY_P99_RATIO,
                      max_value=p99_ratio_max, min_samples=1),
            WatchRule(key=tnames.CANARY_ERROR_BURN,
                      max_value=error_burn_max, min_samples=1),
            WatchRule(key=tnames.CANARY_DRIFT_DELTA,
                      max_value=drift_delta_max, min_samples=1)]
