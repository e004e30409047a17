"""Isolation forest on the fleet stack: supervised fit, compiled serving.

Port of the reference's `workloads/iforest.py`. `models/isolation_forest.py`
is the plain estimator; this module is the same algorithm grown onto the
deployment stack:

- **Serving**: `IsolationForestScorerModel.scoring_plan()` moves the
  array-heap trees to the model's device once (None = the card) and each
  call runs the `depth`-level gather descent of
  `models.isolation_forest._score_forest` there, with no Table on the
  hot path. `_serving_kernel` exposes it to `io/plan.py`, so
  `serve_pipeline` answers with `plan.recompiles` at 0 across same-bucket
  batches. The reference's plan is a numpy descent on the host; the
  port's is the model's own device descent, so a served score equals
  `transform`'s bit for bit.
- **Training**: `IsolationForestScorer._fit` routes through
  `reliability.supervisor.TrainingSupervisor` (one step per tree, the
  four heap arrays are the checkpoint payload, the tree cursor rides
  STEP_KEY). Every tree draws from its own `default_rng([seed, ti, ..])`
  streams, so a killed-and-resumed fit is bit-identical to an
  uninterrupted one regardless of which trees were replayed, and both are
  bit-identical to the reference's fit.
- **Ingest**: `oocore=OocoreOptions(...)` streams the per-tree subsample
  gather through bounded row slabs (`data.chunk.ChunkSource`) instead of
  fancy-indexing the resident matrix per tree.

The reference's `iforest_score_contract` (a JAX lowering contract) is
ROADMAP Queue 1 item 24 and raises NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import Param, Table
from ..core.params import in_range
from ..device import resolve_device
from ..models.isolation_forest import (IsolationForest, IsolationForestModel,
                                       _avg_path_length, _grow_tree,
                                       _score_forest)
from ..reliability.metrics import reliability_metrics
from ..telemetry import names as tnames
from .base import attach_workload_observability


def __getattr__(name: str):
    if name == "iforest_score_contract":
        raise NotImplementedError(
            "workloads.iforest.iforest_score_contract is the reference's JAX "
            "lowering contract, not ported yet (ROADMAP Queue 1 item 24)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _gather_subsamples(x, row_sets, opts) -> list:
    """Streaming sample stage: gather every tree's subsample rows in one
    bounded sweep over row slabs instead of per-tree fancy indexing. One
    slab (`chunk_rows`, d) float32 is resident at a time — the residency
    gauge the oocore binning mapper publishes applies here too."""
    from ..data.chunk import ChunkSource
    n, d = x.shape
    row_bytes = d * 4
    chunk_rows = int(getattr(opts, "chunk_rows", 0) or 0)
    if not chunk_rows:
        budget = int(getattr(opts, "max_resident_bytes", 0) or 0)
        chunk_rows = max((budget or (32 << 20)) // max(row_bytes, 1), 1)
    src = ChunkSource(x, chunk_rows=min(chunk_rows, n))
    out = [np.empty((len(rows), d), np.float32) for rows in row_sets]
    reliability_metrics.set_gauge(tnames.DATA_OOCORE_RESIDENT_BYTES,
                                  float(min(chunk_rows, n) * row_bytes))
    for c in src.chunks:
        slab = np.asarray(x[c.lo:c.hi], np.float32)
        for ti, rows in enumerate(row_sets):
            sel = np.flatnonzero((rows >= c.lo) & (rows < c.hi))
            if len(sel):
                out[ti][sel] = slab[rows[sel] - c.lo]
        reliability_metrics.set_gauge(tnames.DATA_OOCORE_CURSOR, float(c.hi))
    return out


class IsolationForestScorer(IsolationForest):
    """IsolationForest fit routed through the TrainingSupervisor, producing
    a model with a compiled serving plan. Same algorithm and Params as the
    plain estimator, plus the fleet knobs."""
    checkpoint_dir = Param(
        "checkpoint_dir",
        "TrainingSupervisor checkpoint directory; None = plain loop", None)
    checkpoint_every = Param(
        "checkpoint_every", "trees per checkpoint write", 8,
        validator=in_range(0))
    oocore = Param(
        "oocore", "data.oocore.OocoreOptions for the streaming sample "
        "stage (None = resident gather)", None, transient=True)
    faults = Param(
        "faults", "reliability.faults.FaultInjector wired into the "
        "supervisor (chaos drills)", None, transient=True)
    retry_policy = Param(
        "retry_policy", "reliability.policy.RetryPolicy bounding step "
        "restarts (None = supervisor default)", None, transient=True)

    def _fit(self, t: Table) -> "IsolationForestScorerModel":
        x = np.asarray(t[self.features_col])
        if x.ndim != 2:
            raise ValueError(
                f"IsolationForestScorer features {self.features_col!r} "
                "must be (n, d)")
        n, d = x.shape
        n_trees = self.num_estimators
        m_sub = min(self.max_samples, n)
        depth = max(int(np.ceil(np.log2(max(m_sub, 2)))), 1)
        n_nodes = 1 << (depth + 1)  # heap-indexed, root = 1
        d_used = max(int(round(self.max_features * d)), 1)
        seed = int(self.seed or 0)

        # Per-tree seeded streams: draws for tree ti never depend on how
        # many other trees ran in this process, so checkpoint resume (and
        # in-process restart replay) regrows exactly the same forest.
        draw_rngs = [np.random.default_rng([seed, ti, 0])
                     for ti in range(n_trees)]
        row_sets = [(r.choice(n, m_sub, replace=True) if self.bootstrap
                     else r.permutation(n)[:m_sub]) for r in draw_rngs]
        feat_sets = [r.permutation(d)[:d_used] for r in draw_rngs]
        subs = (_gather_subsamples(x, row_sets, self.oocore)
                if self.oocore is not None else None)

        state = {
            "split_feat": np.zeros((n_trees, n_nodes), np.int32),
            "split_thresh": np.full((n_trees, n_nodes), np.inf, np.float32),
            "is_leaf": np.ones((n_trees, n_nodes), bool),
            "path_value": np.zeros((n_trees, n_nodes), np.float32),
        }

        def step_fn(ti: int):
            xt = (subs[ti] if subs is not None
                  else np.asarray(x[row_sets[ti]], np.float32))
            sf, st, lf, pv = _grow_tree(
                xt[:, feat_sets[ti]], np.random.default_rng([seed, ti, 1]),
                depth, n_nodes, feat_sets[ti])
            state["split_feat"][ti] = sf
            state["split_thresh"][ti] = st
            state["is_leaf"][ti] = lf
            state["path_value"][ti] = pv
            reliability_metrics.inc(tnames.WORKLOADS_IFOREST_TREES)
            return int(n_nodes - lf.sum())  # split count, rides the history

        if self.checkpoint_dir:
            from ..reliability.supervisor import TrainingSupervisor

            def snapshot() -> dict:
                return {k: v.copy() for k, v in state.items()}

            def restore(payload: dict) -> None:
                for k in state:
                    state[k][...] = np.asarray(payload[k])

            sup = TrainingSupervisor(
                self.checkpoint_dir, snapshot, restore,
                checkpoint_every=self.checkpoint_every,
                handle_signals=False, faults=self.faults,
                retry_policy=self.retry_policy)
            try:
                sup.run(step_fn, n_trees)
            finally:
                sup.close()
        else:
            for ti in range(n_trees):
                step_fn(ti)

        m = IsolationForestScorerModel(**{p: getattr(self, p) for p in (
            "features_col", "score_col", "predicted_label_col", "device")})
        m._split_feat = state["split_feat"]
        m._split_thresh = state["split_thresh"]
        m._is_leaf = state["is_leaf"]
        m._path_value = state["path_value"]
        m._c_norm = float(_avg_path_length(np.array([m_sub]))[0])
        m._depth = depth
        m._n_features = d
        plan = m.scoring_plan()
        if self.contamination > 0:
            scores = plan(np.asarray(x, np.float32))
            m._threshold = float(np.quantile(scores, 1 - self.contamination))
        else:
            scores = plan(np.asarray(x[:8192], np.float32))
            m._threshold = 2.0  # scores are < 1; nothing labeled outlier
        reliability_metrics.set_gauge(tnames.WORKLOADS_IFOREST_THRESHOLD,
                                      m._threshold)
        # drift reference: the training score distribution — a shifted
        # serving score histogram is the anomaly-rate canary
        attach_workload_observability(self, m, {self.score_col: scores})
        return m


class IsolationForestScorerModel(IsolationForestModel):
    """The plain model plus the compiled serving surface: a prebuilt
    device descent (`scoring_plan`) and the `_serving_kernel` protocol
    that lets `io/plan.py` serve it without Table construction."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._n_features = 0

    def _get_state(self):
        s = super()._get_state()
        s["n_features"] = int(self._n_features)
        return s

    def _set_state(self, s):
        s = dict(s)
        self._n_features = int(np.asarray(s.pop("n_features", 0)))
        super()._set_state(s)

    def scoring_plan(self):
        """Prebuilt descent on the model's device in the
        `Booster.scoring_plan` shape: the heaps move to the device once,
        then each call copies the (n, F) rows there, runs `depth` gather
        levels (`node = 2*node + (x[feat] > thresh)`, int64 nodes) and
        folds the path values to `2^(-mean(h)/c)`, returned as float64 on
        the host. The same descent as `transform`, so the two agree bit
        for bit. A wrong feature width raises ValueError -> per-row 400
        upstream."""
        dev = resolve_device(self.device)
        sf, st, leaf, pv = self._heaps(dev)
        depth = int(self._depth)
        c_norm = float(self._c_norm)
        n_features = int(self._n_features)

        def plan(x: np.ndarray) -> np.ndarray:
            x = np.asarray(x, np.float32)
            if x.ndim != 2 or (n_features and x.shape[1] != n_features):
                raise ValueError(
                    f"expected (n, {n_features}) features, got "
                    f"{getattr(x, 'shape', None)}")
            xt = torch.as_tensor(np.ascontiguousarray(x), device=dev)
            return _score_forest(xt, sf, st, leaf, pv, c_norm,
                                 depth).cpu().numpy().astype(np.float64)

        return plan

    def _serving_kernel(self, output_col: str):
        """(n, F) -> values closure for the io/plan.py fast path: outlier
        scores for `score_col`, the 0/1 contamination label for
        `predicted_label_col`, None otherwise (generic Table plan)."""
        if output_col not in (self.score_col, self.predicted_label_col):
            return None
        plan = self.scoring_plan()
        if output_col == self.predicted_label_col:
            thr = float(self._threshold)

            def kernel(x):
                return (plan(x) >= thr).astype(np.float64)
        else:
            kernel = plan
        kernel.expected_features = int(self._n_features) or None
        return kernel
