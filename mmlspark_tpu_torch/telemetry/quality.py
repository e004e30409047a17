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

The serving half, `StreamingEvaluator`, `QualityMonitor` and the
serving taps (reference `:452-1080`), is ROADMAP Queue 1 item 23:
importing one of its names raises NotImplementedError naming that item.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..reliability.metrics import Histogram

# the serving half of the reference module (item 23)
_SERVING = ("StreamingEvaluator", "QualityMonitor", "merge_quality_exports",
            "get_monitor", "reset_monitor", "configure_quality",
            "observe_serving", "record_label", "export_quality",
            "refresh_quality_gauges", "quality_http_response",
            "quality_watch_rules")


def __getattr__(name: str):
    if name in _SERVING:
        raise NotImplementedError(
            f"telemetry.quality.{name} is the serving half of the quality "
            f"module, not ported yet (ROADMAP Queue 1 item 23)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def merge_moments(n_a: int, mean_a: float, m2_a: float,
                  n_b: int, mean_b: float, m2_b: float) -> tuple:
    """Chan's parallel combine for (count, mean, M2), the reference's
    `utils.stats.merge_moments`: exact over any chunking of the same rows
    up to float association."""
    if n_b == 0:
        return n_a, mean_a, m2_a
    if n_a == 0:
        return n_b, mean_b, m2_b
    n = n_a + n_b
    delta = mean_b - mean_a
    mean = mean_a + delta * n_b / n
    m2 = m2_a + m2_b + delta * delta * n_a * n_b / n
    return n, mean, m2


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
