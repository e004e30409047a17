"""Isolation forest anomaly detector.

Port of the reference's `models/isolation_forest.py` (role: the
reference's isolationforest/IsolationForest.scala, LinkedIn's JVM
implementation):

- Trees are complete binary array-heaps (split_feature / threshold /
  is_leaf / path_value per node, root at index 1), built on the host with
  numpy's `default_rng(seed)` and the vectorized per-level segment
  min/max, draw for draw as the reference does, so the four heaps are
  bit-identical to the reference's.
- Scoring is a fixed-depth descent `node = 2*node + (x[feat] > thresh)`
  over (trees, rows) with `torch.gather` on the model's device (None =
  the card), int64 node indices, rows taken in tiles of `SCORE_TILE` so
  the (trees, rows) index matrix stays bounded (the reference descends
  all rows at once: 800 MB of int64 at 100 trees x 1M rows).

Scoring: s(x) = 2^(-E[h(x)] / c(max_samples)), h = depth + c(leaf_size)
(Isolation Forest, Liu et al. 2008). The tree-path sum is taken in
float64, where a sum of float32 path values up to a few thousand trees
is exact in any order, so the score does not depend on the device or the
tile; the reference sums in float32, which puts the two a few float32
ulps apart.

`iforest_from_reference(model)` carries a fitted reference model's heaps
and `c_norm` into the port's model.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..core import Estimator, Model, Param, Table
from ..core.params import HasFeaturesCol, HasSeed, in_range
from ..device import resolve_device

# rows descended at once: (trees, SCORE_TILE) int64 node indices, 52 MB
# at 100 trees
SCORE_TILE = 1 << 16


def _avg_path_length(n):
    """c(n): average BST unsuccessful-search path length."""
    n = np.asarray(n, np.float64)
    h = np.log(np.maximum(n - 1, 1)) + np.euler_gamma
    return np.where(n > 2, 2 * h - 2 * (n - 1) / np.maximum(n, 1),
                    np.where(n == 2, 1.0, 0.0))


def _score_forest(x: torch.Tensor, sf: torch.Tensor, st: torch.Tensor,
                  leaf: torch.Tensor, pv: torch.Tensor, c_norm: float,
                  depth: int, tile: int = SCORE_TILE) -> torch.Tensor:
    """(n, d) float32 rows -> (n,) float32 scores on x's device.

    `sf` (T, N) int64, `st` (T, N) float32, `leaf` (T, N) bool, `pv`
    (T, N) float32, all on x's device. Each tile of rows descends `depth`
    levels with gathers and sums its trees' path values in float64."""
    n = x.shape[0]
    n_trees = sf.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    for lo in range(0, n, tile):
        xt = x[lo:lo + tile].t().contiguous()            # (d, r)
        r = xt.shape[1]
        node = torch.ones((n_trees, r), dtype=torch.int64, device=x.device)
        for _ in range(depth):
            f = sf.gather(1, node)
            th = st.gather(1, node)
            stop = leaf.gather(1, node)
            val = xt.gather(0, f)                         # x[row, f]
            nxt = 2 * node + (val > th).to(torch.int64)
            node = torch.where(stop, node, nxt)
        h = pv.gather(1, node).sum(0, dtype=torch.float64) / n_trees
        out[lo:lo + r] = torch.pow(2.0, -h / float(c_norm)).to(torch.float32)
    return out


def _grow_tree(xt: np.ndarray, rng, depth: int, n_nodes: int,
               feats: np.ndarray):
    """Grow ONE isolation tree over the feature-sliced subsample `xt`
    (m_sub, d_used) with the vectorized per-level segment min/max build:
    per level, a feature and a threshold in [node-min, node-max] for every
    active node, drawn from `rng` as the reference draws them. Returns the
    four heap rows. The plain fit passes its one stream; the supervised
    fit (`workloads/iforest.py`) a fresh one per tree, so that a replayed
    step grows the same tree."""
    m_sub = xt.shape[0]
    d_used = len(feats)
    split_feat = np.zeros(n_nodes, np.int32)
    split_thresh = np.full(n_nodes, np.inf, np.float32)
    is_leaf = np.ones(n_nodes, bool)
    path_value = np.zeros(n_nodes, np.float32)
    node = np.ones(m_sub, np.int64)  # all samples at root (heap index 1)
    for _level in range(depth):
        uniq = np.unique(node)
        sizes = np.bincount(node, minlength=n_nodes)
        active = uniq[sizes[uniq] > 1]
        if not len(active):
            break
        f_choice = rng.integers(0, d_used, size=n_nodes)
        fcol = xt[np.arange(m_sub), f_choice[node]]
        mins = np.full(n_nodes, np.inf, np.float32)
        maxs = np.full(n_nodes, -np.inf, np.float32)
        np.minimum.at(mins, node, fcol)
        np.maximum.at(maxs, node, fcol)
        u = rng.random(n_nodes).astype(np.float32)
        with np.errstate(invalid="ignore"):  # empty nodes: inf-(-inf)
            thresh = np.where(maxs > mins, mins + u * (maxs - mins), np.inf)
        splittable = np.zeros(n_nodes, bool)
        splittable[active] = maxs[active] > mins[active]
        is_leaf[splittable] = False
        split_feat = np.where(splittable, feats[f_choice],
                              split_feat).astype(np.int32)
        split_thresh = np.where(splittable, thresh, split_thresh)
        go = splittable[node]
        node = np.where(go, 2 * node + (fcol > thresh[node]), node)
    sizes = np.bincount(node, minlength=n_nodes).astype(np.float64)
    node_depth = np.floor(np.log2(np.maximum(
        np.arange(n_nodes), 1))).astype(np.float64)
    pv = node_depth + _avg_path_length(sizes)
    seen = np.unique(node)
    path_value[seen] = pv[seen]
    return split_feat, split_thresh, is_leaf, path_value


class IsolationForest(Estimator, HasFeaturesCol, HasSeed):
    """Fits num_estimators random isolation trees on subsamples."""
    num_estimators = Param("num_estimators", "number of trees", 100,
                           validator=in_range(1))
    max_samples = Param("max_samples", "subsample size per tree", 256,
                        validator=in_range(2))
    max_features = Param("max_features", "fraction of features per tree", 1.0,
                         validator=in_range(0.0, 1.0))
    bootstrap = Param("bootstrap", "sample with replacement", False)
    contamination = Param("contamination",
                          "expected outlier fraction; 0 disables labeling",
                          0.0, validator=in_range(0.0, 0.5))
    score_col = Param("score_col", "outlier score output column",
                      "outlierScore")
    predicted_label_col = Param("predicted_label_col",
                                "0/1 outlier label output column",
                                "predictedLabel")
    device = Param("device", "torch device to score on (None = the card)",
                   None)

    def _fit(self, t: Table) -> "IsolationForestModel":
        x = np.asarray(t[self.features_col], np.float32)
        if x.ndim != 2:
            raise ValueError(
                f"IsolationForest features {self.features_col!r} must be (n, d)")
        n, d = x.shape
        rng = np.random.default_rng(self.seed)
        n_trees = self.num_estimators
        m_sub = min(self.max_samples, n)
        depth = max(int(np.ceil(np.log2(max(m_sub, 2)))), 1)
        n_nodes = 1 << (depth + 1)  # heap-indexed, root = 1

        d_used = max(int(round(self.max_features * d)), 1)
        split_feat = np.zeros((n_trees, n_nodes), np.int32)
        split_thresh = np.full((n_trees, n_nodes), np.inf, np.float32)
        is_leaf = np.ones((n_trees, n_nodes), bool)
        path_value = np.zeros((n_trees, n_nodes), np.float32)

        for ti in range(n_trees):
            rows = (rng.choice(n, m_sub, replace=True) if self.bootstrap
                    else rng.permutation(n)[:m_sub])
            feats = rng.permutation(d)[:d_used]
            (split_feat[ti], split_thresh[ti], is_leaf[ti],
             path_value[ti]) = _grow_tree(x[rows][:, feats], rng, depth,
                                          n_nodes, feats)

        m = IsolationForestModel(**{p: getattr(self, p) for p in (
            "features_col", "score_col", "predicted_label_col", "device")})
        m._split_feat = split_feat
        m._split_thresh = split_thresh
        m._is_leaf = is_leaf
        m._path_value = path_value
        m._c_norm = float(_avg_path_length(np.array([m_sub]))[0])
        m._depth = depth
        # contamination -> score threshold from training scores
        if self.contamination > 0:
            scores = m._score(x)
            m._threshold = float(np.quantile(scores, 1 - self.contamination))
        else:
            m._threshold = 2.0  # scores are < 1; nothing labeled outlier
        return m


class IsolationForestModel(Model, HasFeaturesCol):
    score_col = Param("score_col", "outlier score output column",
                      "outlierScore")
    predicted_label_col = Param("predicted_label_col",
                                "0/1 outlier label output column",
                                "predictedLabel")
    device = Param("device", "torch device to score on (None = the card)",
                   None)

    def __init__(self, **kw):
        super().__init__(**kw)
        self._split_feat = self._split_thresh = None
        self._is_leaf = self._path_value = None
        self._c_norm = self._threshold = None
        self._depth = 0
        self._bound = None            # (device, heap tensors on it)
        self._bound_lock = threading.Lock()

    def _get_state(self):
        return {"split_feat": self._split_feat,
                "split_thresh": self._split_thresh,
                "is_leaf": self._is_leaf, "path_value": self._path_value,
                "c_norm": float(self._c_norm),
                "threshold": float(self._threshold),
                "depth": int(self._depth)}

    def _set_state(self, s):
        self._split_feat = np.asarray(s["split_feat"])
        self._split_thresh = np.asarray(s["split_thresh"])
        self._is_leaf = np.asarray(s["is_leaf"])
        self._path_value = np.asarray(s["path_value"])
        self._c_norm = float(s["c_norm"])
        self._threshold = float(s["threshold"])
        self._depth = int(s["depth"])
        self._bound = None

    def _heaps(self, dev: torch.device) -> tuple:
        """The four heaps on `dev` (int64 features), moved once per
        device; serving's partition workers share them under a lock."""
        with self._bound_lock:
            if self._bound is None or self._bound[0] != dev:
                self._bound = (dev, tuple(torch.as_tensor(
                    np.ascontiguousarray(a, dt), device=dev) for a, dt in (
                    (self._split_feat, np.int64),
                    (self._split_thresh, np.float32),
                    (self._is_leaf, bool),
                    (self._path_value, np.float32))))
            return self._bound[1]

    def _score(self, x: np.ndarray) -> np.ndarray:
        """(n, d) rows -> (n,) float32 scores, descended on the model's
        device and copied back."""
        dev = resolve_device(self.device)
        sf, st, leaf, pv = self._heaps(dev)
        xt = torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)
        return _score_forest(xt, sf, st, leaf, pv, self._c_norm,
                             self._depth).cpu().numpy()

    def _transform(self, t: Table) -> Table:
        x = np.asarray(t[self.features_col], np.float32)
        scores = self._score(x)
        return t.with_columns({
            self.score_col: scores.astype(np.float64),
            self.predicted_label_col:
                (scores >= self._threshold).astype(np.int64)})


def iforest_from_reference(ref_model, cls=None, **params):
    """A port model holding a fitted reference isolation-forest model's
    four heaps, `c_norm`, depth and threshold (numpy arrays, copied).
    `cls` (default `IsolationForestModel`) picks the port class; `params`
    set its Params (e.g. `device`)."""
    cls = IsolationForestModel if cls is None else cls
    m = cls(**params)
    m._set_state({k: np.array(v) if isinstance(v, np.ndarray) else v
                  for k, v in ref_model._get_state().items()})
    return m
