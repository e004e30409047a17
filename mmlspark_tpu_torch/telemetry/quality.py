"""Model-quality observability: the fit-time reference profile.

Port of the first half of the reference's `telemetry/quality.py`
(`:53-450`, which imports no JAX): mergeable streaming sketches
(`FeatureSketch`, `DatasetProfile`: Welford moments, bucket counts over
a grid of quantile edges frozen from a bounded head sample, a bounded
space-saving top-k for categorical columns), the drift scores over
shared grids (`psi`, `js_divergence`, `drift_scores`) and
`matrix_columns`. The GBDT estimators freeze a `DatasetProfile` of the
training rows, label and predictions at fit time (`quality_profile`,
True by default as in the reference) through
`data.pipeline.profile_columns`, and a profile's `state()` equals the
reference's for the same columns.

The serving half (reference `:452-1080`): `StreamingEvaluator` (the
delayed-label join over `train.metrics`' mergeable states),
`QualityMonitor` (the reference profile, its live twin and the
evaluator, fed per served batch by `io/plan.py` through
`observe_serving`), the process-wide monitor (`get_monitor`,
`reset_monitor`, `configure_quality`), `record_label`, `export_quality`,
`refresh_quality_gauges`, `quality_http_response` (GET /quality) and
`merge_quality_exports`, and `quality_watch_rules` (the watcher's rules
over the quality series, `telemetry/watch.py`).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

from ..reliability.metrics import Histogram, reliability_metrics
from ..utils.stats import merge_moments
from . import names as tnames
from .spans import head_sampled

NUMERIC = "numeric"
CATEGORICAL = "categorical"

# profile-capture bounds: reference grids come from a bounded head sample
# (quantile edges need one sort, not the dataset)
DEFAULT_BUCKETS = 10
DEFAULT_TOPK = 32
MAX_REFERENCE_ROWS = 65536

# additive (Laplace) pseudo-count per bucket in the drift math: a bucket
# the live sample merely hasn't hit yet must read as "rare", not as a
# near-zero probability whose log-ratio dominates the score — the classic
# small-sample PSI blow-up
_SMOOTH = 0.5


# ------------------------------------------------------------------ moments
class _Moments:
    """Welford/Chan mergeable moments: n, mean, M2 (sum of squared
    deviations). `update` folds an array vectorized; `merge` is
    `merge_moments`' combine: exact over any chunking of the same rows up
    to float association."""

    __slots__ = ("n", "mean", "m2")

    def __init__(self, n: int = 0, mean: float = 0.0, m2: float = 0.0):
        self.n = int(n)
        self.mean = float(mean)
        self.m2 = float(m2)

    def update(self, values: np.ndarray) -> "_Moments":
        v = np.asarray(values, dtype=np.float64).ravel()
        v = v[np.isfinite(v)]
        if v.size == 0:
            return self
        return self.merge(_Moments(int(v.size), float(v.mean()),
                                   float(((v - v.mean()) ** 2).sum())))

    def merge(self, other: "_Moments") -> "_Moments":
        self.n, self.mean, self.m2 = merge_moments(
            self.n, self.mean, self.m2, other.n, other.mean, other.m2)
        return self

    @property
    def variance(self) -> float:
        return self.m2 / self.n if self.n else 0.0

    def state(self) -> dict:
        return {"n": self.n, "mean": self.mean, "m2": self.m2}

    @classmethod
    def from_state(cls, state: dict) -> "_Moments":
        return cls(state["n"], state["mean"], state["m2"])


# ------------------------------------------------------------------ sketches
class FeatureSketch:
    """One column's mergeable streaming profile.

    Numeric columns hold Welford moments plus bucket counts in a
    `reliability.metrics.Histogram` built over an EXTERNAL grid (the
    quantile edges of the reference sample) — its `state()/from_state()`
    round-trip and `merge_state` count-sum are the mergeable form, shared
    with the latency histograms' scrape merge. Categorical columns hold a
    bounded space-saving top-k counter (capacity `topk`; an evicted key's
    successor inherits its count, the classic overestimate-never-miss
    trade) plus the exact total.
    """

    def __init__(self, name: str, kind: str = NUMERIC,
                 edges: Optional[tuple] = None, topk: int = DEFAULT_TOPK):
        if kind not in (NUMERIC, CATEGORICAL):
            raise ValueError(f"kind must be numeric|categorical, got {kind!r}")
        self.name = name
        self.kind = kind
        self._lock = threading.Lock()
        if kind == NUMERIC:
            self.edges = tuple(float(e) for e in (edges or (0.0,)))
            self.hist = Histogram(f"quality.{name}", bounds=self.edges)
            self.moments = _Moments()
            self._edges_arr = np.asarray(self.edges, dtype=np.float64)
        else:
            self.topk = max(int(topk), 1)
            self.counts: dict = {}
            self.total = 0

    # -- folding --------------------------------------------------------------
    def observe(self, values) -> int:
        """Fold an array of values; returns the number folded. Vectorized:
        one searchsorted + bincount per call, merged into the histogram
        through its public mergeable-state kernel (never per-row
        bisects)."""
        v = np.asarray(values).ravel()
        if v.size == 0:
            return 0
        if self.kind == CATEGORICAL:
            keys, counts = np.unique(v, return_counts=True)
            with self._lock:
                for key, c in zip(keys.tolist(), counts.tolist()):
                    self._add_key(str(key), int(c))
                self.total += int(v.size)
            return int(v.size)
        v = np.asarray(v, dtype=np.float64)
        v = v[np.isfinite(v)]
        if v.size == 0:
            return 0
        # np.searchsorted(side="right") == bisect_right: the same bucket
        # rule Histogram.observe_ms applies one value at a time
        idx = np.searchsorted(self._edges_arr, v, side="right")
        counts = np.bincount(idx, minlength=len(self.edges) + 1)
        self.hist.merge_state({
            "bounds": list(self.edges),
            "counts": counts.tolist(), "count": int(v.size),
            "sum_ms": float(v.sum()), "min_ms": float(v.min()),
            "max_ms": float(v.max())})
        with self._lock:
            self.moments.update(v)
        return int(v.size)

    def _add_key(self, key: str, count: int) -> None:
        """Space-saving insert (lock held): a new key past capacity evicts
        the current minimum and inherits its count — frequent keys can be
        overestimated, never silently missed."""
        if key in self.counts:
            self.counts[key] += count
            return
        if len(self.counts) < self.topk:
            self.counts[key] = count
            return
        min_key = min(sorted(self.counts), key=self.counts.__getitem__)
        floor = self.counts.pop(min_key)
        self.counts[key] = floor + count

    # -- merge / state --------------------------------------------------------
    def merge(self, other) -> "FeatureSketch":
        """Exact fold of another sketch (or its state dict): bucket/topk
        counts sum, moments Chan-merge — never averaged."""
        state = other.state() if isinstance(other, FeatureSketch) else other
        if state["kind"] != self.kind:
            raise ValueError(f"cannot merge {state['kind']} into "
                             f"{self.kind} sketch {self.name!r}")
        if self.kind == CATEGORICAL:
            with self._lock:
                for key in sorted(state["counts"]):
                    self._add_key(str(key), int(state["counts"][key]))
                self.total += int(state["total"])
            return self
        self.hist.merge_state(state["hist"])
        with self._lock:
            self.moments.merge(_Moments.from_state(state["moments"]))
        return self

    def state(self) -> dict:
        if self.kind == CATEGORICAL:
            with self._lock:
                return {"name": self.name, "kind": self.kind,
                        "topk": self.topk, "counts": dict(self.counts),
                        "total": self.total}
        with self._lock:
            moments = self.moments.state()
        return {"name": self.name, "kind": self.kind,
                "edges": list(self.edges), "hist": self.hist.state(),
                "moments": moments}

    @classmethod
    def from_state(cls, state: dict) -> "FeatureSketch":
        if state["kind"] == CATEGORICAL:
            sk = cls(state["name"], CATEGORICAL, topk=state["topk"])
            sk.counts = {str(k): int(v) for k, v in state["counts"].items()}
            sk.total = int(state["total"])
            return sk
        sk = cls(state["name"], NUMERIC, edges=tuple(state["edges"]))
        sk.hist = Histogram.from_state(f"quality.{state['name']}",
                                       state["hist"])
        sk.moments = _Moments.from_state(state["moments"])
        return sk

    def spawn_empty(self) -> "FeatureSketch":
        """A fresh sketch over the SAME grid/keys-capacity — the live tap
        twin of a frozen reference sketch (shared grid is what makes the
        drift counts comparable)."""
        if self.kind == CATEGORICAL:
            return FeatureSketch(self.name, CATEGORICAL, topk=self.topk)
        return FeatureSketch(self.name, NUMERIC, edges=self.edges)

    @property
    def count(self) -> int:
        if self.kind == CATEGORICAL:
            return self.total
        return self.hist.count

    def bucket_counts(self) -> np.ndarray:
        """Counts over the shared grid (numeric) — drift math input."""
        return np.asarray(self.hist.state()["counts"], dtype=np.float64)


def build_numeric_sketch(name: str, values, n_buckets: int = DEFAULT_BUCKETS,
                         max_rows: int = MAX_REFERENCE_ROWS,
                         observe: bool = True) -> FeatureSketch:
    """Reference-time constructor: quantile bucket edges from a bounded
    head sample of `values`, then (with `observe`) the sample folded in
    — `observe=False` freezes the grid only, for callers that fold rows
    themselves (the chunked ingest tap; folding here too would profile
    the sample twice). The resulting grid is the frozen contract every
    live sketch and every worker shares — drift is only defined over
    identical grids."""
    v = np.asarray(values, dtype=np.float64).ravel()[:max(int(max_rows), 1)]
    finite = v[np.isfinite(v)]
    if finite.size == 0:
        edges: tuple = (0.0,)
    else:
        qs = np.linspace(0.0, 1.0, max(int(n_buckets), 2) + 1)[1:-1]
        edges = tuple(np.unique(np.quantile(finite, qs)).tolist())
        if not edges:
            edges = (float(finite[0]),)
    sk = FeatureSketch(name, NUMERIC, edges=edges)
    if observe:
        sk.observe(v)
    return sk


# --------------------------------------------------------------- drift math
def _normalize(counts, smooth: float = _SMOOTH) -> np.ndarray:
    c = np.asarray(counts, dtype=np.float64)
    c = np.maximum(c, 0.0) + smooth
    return c / c.sum()


def psi(ref_counts, live_counts, smooth: float = _SMOOTH) -> float:
    """Population Stability Index over two count vectors on ONE shared
    grid: sum((q - p) * ln(q / p)) with an additive `smooth` pseudo-count
    per bucket (Laplace) — an empty bucket reads as rare, not as a
    log-ratio singularity, so a few dozen live samples score noise-level
    drift instead of tripping the SLO on startup. Rule-of-thumb scale:
    < 0.1 stable, 0.1-0.25 drifting, > 0.25 shifted (the bound
    `slo.quality_objectives` defaults to)."""
    p = _normalize(ref_counts, smooth)
    q = _normalize(live_counts, smooth)
    return float(((q - p) * np.log(q / p)).sum())


def js_divergence(ref_counts, live_counts,
                  smooth: float = _SMOOTH) -> float:
    """Jensen-Shannon divergence (base 2, in [0, 1]) over two count
    vectors on one shared grid — bounded and symmetric where PSI is
    neither, so the pair brackets the drift claim. Same Laplace
    smoothing as `psi`."""
    p = _normalize(ref_counts, smooth)
    q = _normalize(live_counts, smooth)
    m = 0.5 * (p + q)
    kl_pm = (p * np.log2(p / m)).sum()
    kl_qm = (q * np.log2(q / m)).sum()
    return float(0.5 * kl_pm + 0.5 * kl_qm)


def _categorical_vectors(ref: dict, live: dict,
                         ref_total: int, live_total: int):
    """Aligned count vectors over the union of top-k keys plus an
    `other` bucket holding each side's residual mass (total minus the
    tracked keys) — both sides see the same support."""
    keys = sorted(set(ref) | set(live))
    r = [float(ref.get(k, 0)) for k in keys]
    lv = [float(live.get(k, 0)) for k in keys]
    r.append(max(float(ref_total) - sum(r), 0.0))
    lv.append(max(float(live_total) - sum(lv), 0.0))
    return np.asarray(r), np.asarray(lv)


def drift_scores(reference: "DatasetProfile",
                 live: "DatasetProfile") -> dict:
    """{col: {psi, js, ref_count, live_count}} over every column both
    profiles carry. Grids are shared by construction (`spawn_live`); a
    column whose grids diverged anyway (mixed profile versions) is
    reported with `grid_mismatch` instead of a silently-wrong score."""
    out: dict = {}
    for name in sorted(reference.columns):
        ref = reference.columns[name]
        lv = live.columns.get(name)
        if lv is None or lv.kind != ref.kind:
            continue
        row = {"kind": ref.kind, "ref_count": int(ref.count),
               "live_count": int(lv.count)}
        if lv.count == 0:
            # no live traffic folded yet: no claim, not "zero drift"
            row["psi"] = None
            row["js"] = None
            out[name] = row
            continue
        if ref.kind == CATEGORICAL:
            r, q = _categorical_vectors(ref.counts, lv.counts,
                                        ref.total, lv.total)
        else:
            if tuple(ref.edges) != tuple(lv.edges):
                row["grid_mismatch"] = True
                out[name] = row
                continue
            r, q = ref.bucket_counts(), lv.bucket_counts()
        row["psi"] = psi(r, q)
        row["js"] = js_divergence(r, q)
        out[name] = row
    return out


# ----------------------------------------------------------------- profiles
def matrix_columns(x, prefix: str = "f") -> dict:
    """Expand an (n, F) features matrix into the canonical per-slot
    column names (`f0`..`f{F-1}`) the reference and live taps both use —
    one naming rule so the grids line up."""
    x = np.asarray(x)
    if x.ndim == 1:
        return {f"{prefix}0": x}
    return {f"{prefix}{i}": x[:, i] for i in range(x.shape[1])}


class DatasetProfile:
    """A set of named `FeatureSketch`es — one dataset's distribution
    profile. `fit()` freezes grids from reference data; `spawn_live()`
    twins it with empty sketches over the SAME grids; `merge()`/`state()`
    are the exact chunk/fleet fold (counts sum, never averaged)."""

    def __init__(self, columns: Optional[dict] = None):
        self.columns: dict = dict(columns or {})

    @classmethod
    def fit(cls, columns: dict, n_buckets: int = DEFAULT_BUCKETS,
            categorical=(), topk: int = DEFAULT_TOPK,
            max_rows: int = MAX_REFERENCE_ROWS,
            observe: bool = True) -> "DatasetProfile":
        """Build the reference profile from named column arrays: numeric
        columns get quantile bucket grids (and, with `observe`, the
        bounded head sample folded in); names listed in `categorical` get
        bounded top-k counters. `observe=False` freezes grids only — the
        caller folds rows itself (e.g. `data.pipeline.profile_columns`
        chunk by chunk)."""
        cat = set(str(c) for c in categorical)
        prof = cls()
        for name in sorted(columns):
            v = np.asarray(columns[name]).ravel()
            if name in cat:
                sk = FeatureSketch(name, CATEGORICAL, topk=topk)
                if observe:
                    sk.observe(v[:max_rows])
            else:
                sk = build_numeric_sketch(name, v, n_buckets=n_buckets,
                                          max_rows=max_rows,
                                          observe=observe)
            prof.columns[name] = sk
        return prof

    def spawn_live(self) -> "DatasetProfile":
        return DatasetProfile({name: sk.spawn_empty()
                               for name, sk in self.columns.items()})

    def observe(self, name: str, values) -> int:
        sk = self.columns.get(name)
        if sk is None:
            return 0
        return sk.observe(values)

    def merge(self, other) -> "DatasetProfile":
        state = other.state() if isinstance(other, DatasetProfile) else other
        for name in sorted(state.get("columns", {})):
            st = state["columns"][name]
            sk = self.columns.get(name)
            if sk is None:
                self.columns[name] = FeatureSketch.from_state(st)
            else:
                sk.merge(st)
        return self

    def state(self) -> dict:
        return {"columns": {name: sk.state()
                            for name, sk in sorted(self.columns.items())}}

    @classmethod
    def from_state(cls, state: dict) -> "DatasetProfile":
        return cls({name: FeatureSketch.from_state(st)
                    for name, st in state.get("columns", {}).items()})

    @property
    def count(self) -> int:
        return max((sk.count for sk in self.columns.values()), default=0)


# -------------------------------------------------- online evaluation (join)
class StreamingEvaluator:
    """Delayed-label join + mergeable streaming evaluation.

    `record_prediction(request_id, value)` parks the served value in a
    bounded FIFO window; `record_label(request_id, label)` joins against
    it and folds the pair into the SAME mergeable metric state batch
    `ComputeModelStatistics` finalizes (`train.metrics.ConfusionState` /
    `RegressionState` — streaming and batch share one kernel by
    construction). The label stream is hostile by assumption and every
    anomaly is COUNTED, never crashed:

    - a label arriving BEFORE its prediction parks in a bounded buffer
      and joins when the prediction lands (`quality.labels.late`);
    - a second label for an already-joined id is ignored once counted
      (`quality.labels.dup`);
    - a label whose prediction aged out of the join window — or whose
      parked slot was evicted — counts `quality.labels.dropped`.

    `kind="auto"` resolves on the first join (both sides integer-like =>
    classification, the `ComputeModelStatistics` heuristic); AUC-style
    rank metrics need the full score ordering and stay batch-only.
    HOSTILE values honor the same contract: a non-finite label/prediction
    or a classification label outside [0, MAX_CLASSES) is counted
    dropped, never folded — one label of 1e9 must not allocate a
    1e9-class confusion matrix (or wrap a negative index into it).
    Chaos: the `quality.label` fault site fires per label when an
    injector is attached — kind ``drop`` loses the label pre-join
    (counted dropped), so seeded schedules replay identical anomaly
    sequences.

    Joined pairs are also PUSHED: `subscribe(fn)` (or `on_join=`)
    registers a `fn(request_id, prediction, label)` callback fired once
    per successful join, outside the evaluator lock. Fan-out is bounded
    (`MAX_SUBSCRIBERS`) and a raising subscriber is counted
    (`quality.join.subscriber_errors`) and absorbed — a bad consumer
    can never kill the evaluator or undo the join. This is the label
    feed an online learner trains from."""

    # classification joins outside [0, MAX_CLASSES) are invalid input,
    # not a request to grow the count matrix without bound
    MAX_CLASSES = 256
    # joined-pair fan-out is bounded like every other buffer here
    MAX_SUBSCRIBERS = 8

    def __init__(self, kind: str = "auto", max_pending: int = 4096,
                 max_parked: int = 1024, registry=None, faults=None,
                 on_join=None):
        if kind not in ("auto", "classification", "regression"):
            raise ValueError(
                "kind must be auto|classification|regression")
        self.kind = kind
        self.max_pending = max(int(max_pending), 1)
        self.max_parked = max(int(max_parked), 1)
        self._metrics = registry if registry is not None \
            else reliability_metrics
        self._faults = faults
        self._subscribers: list = []
        if on_join is not None:
            self.subscribe(on_join)
        self._lock = threading.Lock()
        self._resolved: Optional[str] = None if kind == "auto" else kind
        self._pending: OrderedDict = OrderedDict()   # id -> prediction
        self._parked: OrderedDict = OrderedDict()    # id -> label
        self._evicted: OrderedDict = OrderedDict()   # bounded id tombstones
        self._joined: OrderedDict = OrderedDict()    # bounded joined ids
        self._cls = None
        self._reg = None
        self._joined_total = 0

    # -- join fan-out ---------------------------------------------------------
    def subscribe(self, callback):
        """Register `fn(request_id, prediction, label)`, fired once per
        successful join. Bounded: past MAX_SUBSCRIBERS is a config
        error, not a silent drop."""
        if not callable(callback):
            raise TypeError("on_join subscriber must be callable")
        if len(self._subscribers) >= self.MAX_SUBSCRIBERS:
            raise ValueError(
                f"subscriber fan-out is bounded at {self.MAX_SUBSCRIBERS}")
        self._subscribers.append(callback)
        return callback

    def _notify_join(self, rid: str, pred: float, label: float) -> None:
        """Fan a joined pair out to subscribers — called with the lock
        RELEASED (a subscriber may call back into the evaluator). A
        raising subscriber is counted and absorbed; the join stands."""
        for fn in list(self._subscribers):
            try:
                fn(rid, pred, label)
            except Exception:
                self._metrics.inc(tnames.QUALITY_JOIN_SUBSCRIBER_ERRORS)

    # -- value plumbing -------------------------------------------------------
    @staticmethod
    def _scalar(value) -> float:
        arr = np.asarray(value, dtype=np.float64)
        if arr.size == 1:
            return float(arr.reshape(()))
        # vector outputs (probabilities): the predicted class
        return float(arr.argmax())

    def _resolve(self, pred: float, label: float) -> str:
        if self._resolved is None:
            int_like = (float(pred).is_integer()
                        and float(label).is_integer()
                        and 0 <= label <= 100 and 0 <= pred <= 100)
            self._resolved = "classification" if int_like else "regression"
        return self._resolved

    def _join(self, rid: str, pred: float, label: float) -> bool:
        """Fold one (prediction, label) pair — lock held. Returns False
        (caller counts the label dropped) for values that cannot be
        folded: non-finite on either side, or a classification id
        outside [0, MAX_CLASSES)."""
        from ..train.metrics import ConfusionState, RegressionState
        if not (np.isfinite(pred) and np.isfinite(label)):
            return False
        kind = self._resolve(pred, label)
        if kind == "classification":
            yi, pi = int(round(label)), int(round(pred))
            if not (0 <= yi < self.MAX_CLASSES
                    and 0 <= pi < self.MAX_CLASSES):
                return False
            if self._cls is None:
                self._cls = ConfusionState(2)
            self._cls.update([yi], [pi])
        else:
            if self._reg is None:
                self._reg = RegressionState()
            self._reg.update([label], [pred])
        self._joined[rid] = None
        while len(self._joined) > self.max_pending:
            self._joined.popitem(last=False)
        self._joined_total += 1
        self._metrics.inc(tnames.QUALITY_LABELS_JOINED)
        self._set_eval_gauges()
        return True

    def _set_eval_gauges(self) -> None:
        """Current metric values as gauges (lock held; the registry uses
        its own lock — quality -> registry is the one nesting order).
        Counter-side rates (`quality.labels.*`) carry the windowed view;
        the gauges are the last-value summary the SLO floor reads."""
        for name, value in sorted(self._metric_values().items()):
            self._metrics.set_gauge(tnames.quality_eval(name), value)

    def _metric_values(self) -> dict:
        if self._resolved == "classification" and self._cls is not None:
            vals = self._cls.binary()
            return {"accuracy": float(vals["accuracy"]),
                    "precision": float(vals["precision"]),
                    "recall": float(vals["recall"])}
        if self._resolved == "regression" and self._reg is not None:
            vals = self._reg.metrics()
            return {"rmse": float(vals["rmse"]), "mae": float(vals["mae"])}
        return {}

    # -- the join -------------------------------------------------------------
    def record_prediction(self, request_id: str, value) -> str:
        v = self._scalar(value)
        with self._lock:
            label = self._parked.pop(request_id, None)
            if label is not None:
                # out-of-order: the label beat its prediction here
                if not self._join(request_id, v, label):
                    self._metrics.inc(tnames.QUALITY_LABELS_DROPPED)
                    return "dropped"
                self._metrics.inc(tnames.QUALITY_LABELS_LATE)
            elif request_id in self._joined:
                return "joined"
            else:
                self._pending[request_id] = v
                while len(self._pending) > self.max_pending:
                    old, _ = self._pending.popitem(last=False)
                    self._evicted[old] = None
                    while len(self._evicted) > self.max_pending:
                        self._evicted.popitem(last=False)
                return "pending"
        # late join succeeded: fan out with the lock released
        self._notify_join(request_id, v, label)
        return "late-join"

    def record_label(self, request_id: str, label) -> str:
        if self._faults is not None:
            fault = self._faults.fire("quality.label")
            if fault is not None and fault.kind == "drop":
                # injected label loss: the join window never sees it
                self._metrics.inc(tnames.QUALITY_LABELS_DROPPED)
                return "dropped"
        try:
            y = self._scalar(label)
        except (TypeError, ValueError):
            # unparsable label (a string, a ragged object) — counted,
            # never crashed
            self._metrics.inc(tnames.QUALITY_LABELS_DROPPED)
            return "dropped"
        with self._lock:
            if request_id in self._joined:
                self._metrics.inc(tnames.QUALITY_LABELS_DUP)
                return "dup"
            pred = self._pending.pop(request_id, None)
            if pred is not None:
                if not self._join(request_id, pred, y):
                    # unfoldable (non-finite / out-of-range) label:
                    # counted, never crashed — the contract
                    self._metrics.inc(tnames.QUALITY_LABELS_DROPPED)
                    return "dropped"
                pass
            elif request_id in self._evicted:
                # label-after-eviction: the prediction aged out of the
                # bounded window before its label arrived
                self._evicted.pop(request_id, None)
                self._metrics.inc(tnames.QUALITY_LABELS_DROPPED)
                return "dropped"
            else:
                # label BEFORE prediction: park it for the late join
                self._parked[request_id] = y
                while len(self._parked) > self.max_parked:
                    self._parked.popitem(last=False)
                    self._metrics.inc(tnames.QUALITY_LABELS_DROPPED)
                return "parked"
        # joined inside the lock: fan out with it released
        self._notify_join(request_id, pred, y)
        return "joined"

    # -- read side ------------------------------------------------------------
    def metrics(self) -> dict:
        with self._lock:
            return self._metric_values()

    def export(self) -> dict:
        with self._lock:
            out = {"kind": self._resolved, "joined": self._joined_total,
                   "pending": len(self._pending),
                   "parked": len(self._parked),
                   "metrics": self._metric_values()}
            if self._cls is not None:
                out["confusion"] = self._cls.state()
            if self._reg is not None:
                out["regression"] = self._reg.state()
        return out

    def merge_export(self, export: dict) -> "StreamingEvaluator":
        """Fold another evaluator's export (counts sum — the fleet
        merge; `pending`/`parked` are per-worker live state and do not
        merge)."""
        from ..train.metrics import ConfusionState, RegressionState
        with self._lock:
            if export.get("kind") and self._resolved is None:
                self._resolved = export["kind"]
            if "confusion" in export:
                other = ConfusionState.from_state(export["confusion"])
                if self._cls is None:
                    self._cls = other
                else:
                    self._cls.merge(other)
            if "regression" in export:
                other = RegressionState.from_state(export["regression"])
                if self._reg is None:
                    self._reg = other
                else:
                    self._reg.merge(other)
            self._joined_total += int(export.get("joined", 0))
        return self


# ------------------------------------------------------------------ monitor
class QualityMonitor:
    """The process-wide quality tap: reference profile + live profile +
    streaming evaluator, folded from the serving hot path and read by
    `/quality`, the drift gauges, the SLO engine, and the flight
    recorder. Inactive (one boolean test per serving batch) until a
    reference is installed."""

    def __init__(self, registry=None):
        self._registry = registry if registry is not None \
            else reliability_metrics
        self._lock = threading.Lock()
        self.reference: Optional[DatasetProfile] = None
        self.live: Optional[DatasetProfile] = None
        self.evaluator = StreamingEvaluator(registry=registry)
        self.sample = 1.0
        self.labels_enabled = True
        # gauge-publication floor: PSI over a handful of live rows is
        # sampling noise, not drift — a column's gauge only publishes
        # once its live sketch holds this many rows (the export still
        # carries every row's score for drill-down; no-data burns 0 in
        # the SLO, so a fresh worker never starts life "burning")
        self.min_live = 100
        # id-less callers still honor the sample rate via systematic
        # row-count sampling (every round(1/sample)-th row, offset
        # carried across batches)
        self._row_cursor = 0
        self._active = False

    @property
    def active(self) -> bool:
        return self._active

    def set_reference(self, profile, reset_live: bool = True
                      ) -> "QualityMonitor":
        """Install the frozen reference profile (a `DatasetProfile` or
        its `state()` dict — the form the GBDT estimators stash on fitted
        models) and spawn the live twin over the same grids.

        `ServingTransform.install_model` calls this on every hot-swap
        AFTER the version registry freezes the incumbent's canary
        baseline (telemetry/lineage.py) — the baseline must read the OLD
        reference's drift, and the reset below is what clears the old
        model's stale `quality.drift.*` gauges from the swap onward."""
        prof = (profile if isinstance(profile, DatasetProfile)
                else DatasetProfile.from_state(profile))
        with self._lock:
            self.reference = prof
            if reset_live or self.live is None:
                self.live = prof.spawn_live()
            self._active = True
        # a fresh reference invalidates every published drift gauge: the
        # old model's drift must not keep an SLO burning (or a watcher
        # tripped) against a model no longer being served — gauges
        # republish once the new live profile crosses min_live
        self._registry.reset("quality.drift")
        return self

    def configure(self, sample: Optional[float] = None,
                  labels: Optional[bool] = None,
                  min_live: Optional[int] = None,
                  evaluator: Optional[StreamingEvaluator] = None
                  ) -> "QualityMonitor":
        with self._lock:
            if sample is not None:
                self.sample = float(sample)
            if labels is not None:
                self.labels_enabled = bool(labels)
            if min_live is not None:
                self.min_live = max(int(min_live), 1)
            if evaluator is not None:
                self.evaluator = evaluator
        return self

    # -- the serving tap ------------------------------------------------------
    def observe_serving(self, features, predictions,
                        request_ids: Optional[list] = None) -> int:
        """Fold one served batch: predictions enter the label-join window
        (all rows — one dict insert each), and the live sketches fold a
        HEAD-SAMPLED subset — the decision is `crc32(request_id)`, the
        span sampler's own deterministic rule, so independent workers
        agree per id and the continuous batch-of-1 path pays one crc32 +
        (rate-proportionally) one sketch fold. Returns rows folded into
        the sketches."""
        if not self._active:
            return 0
        preds = np.asarray(predictions)
        if self.labels_enabled and request_ids is not None:
            for i, rid in enumerate(request_ids):
                if rid is not None:
                    self.evaluator.record_prediction(rid, preds[i])
        if self.sample <= 0.0:
            return 0
        n_rows = preds.shape[0] if preds.ndim else 1
        if request_ids is None:
            # no ids to hash: systematic sampling at the SAME rate — an
            # id-less transport must not silently fold 100% of traffic
            if self.sample >= 1.0:
                sel = list(range(n_rows))
            else:
                stride = max(int(round(1.0 / self.sample)), 1)
                with self._lock:
                    cursor = self._row_cursor
                    self._row_cursor = (cursor + n_rows) % stride
                sel = [i for i in range(n_rows)
                       if (cursor + i) % stride == 0]
        else:
            sel = [i for i, rid in enumerate(request_ids)
                   if rid is not None and head_sampled(rid, self.sample)]
        if not sel:
            return 0
        live = self.live
        if isinstance(features, dict):
            cols: dict = {}
            for cname in sorted(features):
                arr = np.asarray(features[cname])
                if arr.ndim >= 2:
                    cols.update(matrix_columns(arr))
                else:
                    cols[cname] = arr
        else:
            cols = matrix_columns(features)
        folded = 0
        for cname in sorted(cols):
            if cname in live.columns:
                folded = max(folded,
                             live.observe(cname, np.take(cols[cname], sel,
                                                         axis=0)))
        if "prediction" in live.columns:
            live.observe("prediction", np.take(preds, sel, axis=0))
        if folded:
            self._registry.inc(tnames.QUALITY_SKETCH_ROWS, folded)
        return folded

    def record_label(self, request_id: str, label) -> str:
        """The application-side half of the delayed-label join (ids are
        the `X-Request-Id` serving returned)."""
        return self.evaluator.record_label(request_id, label)

    # -- read side ------------------------------------------------------------
    def drift(self) -> dict:
        with self._lock:
            ref, live = self.reference, self.live
        if ref is None or live is None:
            return {}
        return drift_scores(ref, live)

    def refresh_gauges(self, registry=None) -> dict:
        """Compute drift and publish the `quality.drift.{col}` (PSI)
        gauges plus the `quality.drift.max` roll-up — called on every
        exposition scrape so `/metrics[.json]`, the poller series, and
        the SLO engine all read fresh drift."""
        rows = self.drift()
        reg = registry if registry is not None else self._registry
        # republish from a clean slate: a gauge published on an earlier
        # refresh must not outlive the column (or model) that produced
        # it — stale drift is exactly the false page this tier exists
        # to prevent
        reg.reset("quality.drift")
        if not rows:
            return rows
        worst = 0.0
        have = False
        for col in sorted(rows):
            value = rows[col].get("psi")
            if value is None or rows[col]["live_count"] < self.min_live:
                # below the publication floor: small-sample PSI is noise
                # — the row stays in the export, the gauge stays absent
                continue
            reg.set_gauge(tnames.quality_drift(col), float(value))
            worst = max(worst, float(value))
            have = True
        if have:
            reg.set_gauge(tnames.QUALITY_DRIFT_MAX, worst)
        return rows

    def export(self) -> dict:
        """The `/quality` + flight-bundle payload: reference/live sketch
        states (the exactly-mergeable form), per-column drift rows, and
        the streaming-eval state."""
        with self._lock:
            active = self._active
            ref = self.reference.state() if self.reference else None
            live = self.live.state() if self.live else None
            sample = self.sample
        out = {"active": active, "sample": sample,
               "drift": self.drift(), "eval": self.evaluator.export()}
        if ref is not None:
            out["reference"] = ref
        if live is not None:
            out["live"] = live
        return out


def _grids_compatible(live: "DatasetProfile", state: dict) -> bool:
    """Can `state` fold into `live` exactly? Shared columns must agree on
    kind and (numeric) bucket edges — checked before any fold so an
    incompatible worker contributes nothing rather than a partial sum."""
    for name in sorted(state.get("columns", {})):
        st = state["columns"][name]
        sk = live.columns.get(name)
        if sk is None:
            continue
        if st.get("kind") != sk.kind:
            return False
        if sk.kind == NUMERIC and list(st.get("edges", ())) != \
                list(sk.edges):
            return False
    return True


def merge_quality_exports(exports: list) -> Optional[dict]:
    """Fleet merge of per-worker `/quality` exports: LIVE sketch counts
    sum exactly across workers (never averaged), eval states fold through
    the same `ConfusionState`/`RegressionState` merges, drift is
    RECOMPUTED from the merged counts against the (shared) reference —
    the `merge_verdicts` discipline applied to semantics."""
    exports = [e for e in exports if e and e.get("active")]
    if not exports:
        return None
    reference = None
    live = None
    evaluator = StreamingEvaluator(registry=_null_registry())
    merged = 0
    skipped = 0
    for e in exports:
        # per-worker isolation: a mid-rollout fleet may mix model
        # versions whose sketch grids differ — that worker's export is
        # SKIPPED (and counted), never allowed to kill the whole merge.
        # Compatibility is checked BEFORE folding so a mismatch cannot
        # leave a partial (inexact) contribution behind.
        try:
            if "live" in e:
                if live is None:
                    live = DatasetProfile.from_state(e["live"])
                elif not _grids_compatible(live, e["live"]):
                    skipped += 1
                    continue
                else:
                    live.merge(e["live"])
            if "eval" in e:
                evaluator.merge_export(e["eval"])
            if reference is None and "reference" in e:
                reference = DatasetProfile.from_state(e["reference"])
            merged += 1
        except (KeyError, TypeError, ValueError):
            skipped += 1
    out = {"active": True, "workers": merged,
           "eval": evaluator.export()}
    if skipped:
        out["workers_skipped"] = skipped
    if reference is not None and live is not None:
        out["drift"] = drift_scores(reference, live)
        out["live"] = live.state()
    return out


class _NullRegistry:
    """Metric sink for merge-only evaluators: a fleet merge must not
    bump this process's own counters/gauges."""

    def inc(self, name, n=1):
        return 0

    def set_gauge(self, name, value):
        pass


_null = _NullRegistry()


def _null_registry() -> _NullRegistry:
    return _null


# ------------------------------------------------------- process-wide default
_monitor: Optional[QualityMonitor] = None
_monitor_lock = threading.Lock()


def get_monitor() -> QualityMonitor:
    global _monitor
    with _monitor_lock:
        if _monitor is None:
            _monitor = QualityMonitor()
        return _monitor


def reset_monitor() -> QualityMonitor:
    """Replace the process-default monitor (tests isolate scenarios)."""
    global _monitor
    with _monitor_lock:
        _monitor = QualityMonitor()
        return _monitor


def configure_quality(**kwargs) -> QualityMonitor:
    return get_monitor().configure(**kwargs)


def observe_serving(features, predictions, request_ids=None) -> int:
    """Hot-path entry (io/plan.py calls this per served batch): a cheap
    no-op until a reference profile is installed; never raises into the
    serving worker."""
    monitor = _monitor
    if monitor is None or not monitor.active:
        return 0
    try:
        return monitor.observe_serving(features, predictions, request_ids)
    except Exception:  # noqa: BLE001 - observability must not fail serving
        return 0


def record_label(request_id: str, label) -> str:
    return get_monitor().record_label(request_id, label)


def export_quality() -> dict:
    """JSON-safe export of the process monitor (flight bundles dump this
    as quality.json; {"active": False} until a reference exists). Never
    raises — a broken sketch loses the quality block, not the bundle."""
    monitor = _monitor
    if monitor is None or not monitor.active:
        return {"active": False}
    try:
        return monitor.export()
    except Exception:  # noqa: BLE001
        return {"active": False}


def refresh_quality_gauges(registry=None) -> dict:
    """Exposition hook: refresh drift gauges right before a scrape (the
    resource-gauge pattern). No-op until the monitor is active."""
    monitor = _monitor
    if monitor is None or not monitor.active:
        return {}
    try:
        return monitor.refresh_gauges(registry)
    except Exception:  # noqa: BLE001 - a scrape never fails on drift math
        return {}


def quality_http_response() -> tuple:
    """(status, payload, content_type) for GET /quality — the shared
    handler body every exposition surface mounts."""
    import json
    return 200, json.dumps(export_quality()).encode(), "application/json"


def quality_watch_rules(max_drift: float = 0.25,
                        min_metric: Optional[float] = None,
                        metric: str = "quality.eval.accuracy") -> list:
    """Watcher rules over the quality series: trip when the fleet's worst
    per-column PSI exceeds `max_drift`, and (optionally) when the online
    metric sinks under `min_metric`; feed to `TelemetryWatcher(rules=)`."""
    from .watch import WatchRule
    rules = [WatchRule(key=tnames.QUALITY_DRIFT_MAX, max_value=max_drift,
                       min_samples=1)]
    if min_metric is not None:
        rules.append(WatchRule(key=metric, min_value=min_metric,
                               min_samples=1))
    return rules
