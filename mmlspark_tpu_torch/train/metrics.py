"""Metric computation core, host numpy: the port's copy of the reference's
`train/metrics.py` (which imports no JAX).

The sufficient statistics live in MERGEABLE state objects
(`ConfusionState` for classification, `RegressionState` for regression):
counts and sums that add exactly across chunks and across workers, never
averaged, as `reliability.metrics.Histogram` bucket merges. The batch
functions (`multiclass_metrics`, `binary_metrics`, `regression_metrics`)
build a state from whole arrays and finalize it; the streaming evaluator
(`telemetry.quality.StreamingEvaluator`) folds the same states row by
row, so batch and online evaluation share one finalize kernel. Rank
statistics (AUC/AUPR/NDCG) need the full score ordering and stay
batch-only. The rest of the reference's `train/` is ROADMAP Queue 1
item 27.
"""
from __future__ import annotations

import numpy as np

# reference: MetricConstants.scala names
CLASSIFICATION_METRICS = ["accuracy", "precision", "recall", "AUC"]
REGRESSION_METRICS = ["mse", "rmse", "r2", "mae"]


class ConfusionState:
    """Mergeable confusion-matrix state: a (k, k) int64 count matrix that
    grows as new class ids arrive. `update` folds arrays, `merge` sums
    two states exactly (padding to the larger k), and `metrics()` is THE
    classification finalize kernel — the macro/micro formulas the
    reference cites (ComputeModelStatistics.scala:330-436), shared
    verbatim by the batch transformers and the streaming evaluator."""

    __slots__ = ("cm",)

    def __init__(self, n_classes: int = 2):
        k = max(int(n_classes), 1)
        self.cm = np.zeros((k, k), dtype=np.int64)

    def _ensure(self, k: int) -> None:
        if k > self.cm.shape[0]:
            grown = np.zeros((k, k), dtype=np.int64)
            grown[:self.cm.shape[0], :self.cm.shape[1]] = self.cm
            self.cm = grown

    def update(self, y_true, y_pred) -> "ConfusionState":
        y_true = np.asarray(y_true).astype(int)
        y_pred = np.asarray(y_pred).astype(int)
        if y_true.size:
            self._ensure(int(max(y_true.max(), y_pred.max())) + 1)
            np.add.at(self.cm, (y_true, y_pred), 1)
        return self

    @classmethod
    def from_arrays(cls, y_true, y_pred, n_classes=None) -> "ConfusionState":
        if n_classes:
            # an EXPLICIT class count is a contract, not a floor: a label
            # outside [0, n_classes) raises (numpy fancy-index bounds)
            # exactly like the pre-state confusion_matrix kernel did —
            # silently growing the matrix would fold stray labels into
            # metrics whose reader asked for k classes
            st = cls(n_classes)
            y_true = np.asarray(y_true).astype(int)
            y_pred = np.asarray(y_pred).astype(int)
            np.add.at(st.cm, (y_true, y_pred), 1)
            return st
        return cls(1).update(y_true, y_pred)

    def merge(self, other: "ConfusionState") -> "ConfusionState":
        """Exact merge: integer counts sum (never averaged)."""
        self._ensure(other.cm.shape[0])
        self.cm[:other.cm.shape[0], :other.cm.shape[1]] += other.cm
        return self

    # -- raw state (JSON round-trip / cross-worker merge) ---------------------
    def state(self) -> dict:
        return {"cm": self.cm.tolist()}

    @classmethod
    def from_state(cls, state: dict) -> "ConfusionState":
        st = cls(1)
        st.cm = np.asarray(state["cm"], dtype=np.int64)
        if st.cm.ndim != 2 or st.cm.shape[0] != st.cm.shape[1]:
            raise ValueError("confusion state must be a square count matrix")
        return st

    # -- finalize kernels -----------------------------------------------------
    @property
    def count(self) -> int:
        return int(self.cm.sum())

    def metrics(self) -> dict:
        """Macro/micro averaged classification metrics from the counts."""
        cm = self.cm
        tp = np.diag(cm).astype(np.float64)
        fp = cm.sum(axis=0) - tp
        fn = cm.sum(axis=1) - tp
        total = cm.sum()
        per_class_precision = tp / np.maximum(tp + fp, 1)
        per_class_recall = tp / np.maximum(tp + fn, 1)
        micro_p = tp.sum() / max((tp + fp).sum(), 1)
        micro_r = tp.sum() / max((tp + fn).sum(), 1)
        return {
            "accuracy": tp.sum() / max(total, 1),
            "precision": micro_p,        # micro (reference default)
            "recall": micro_r,
            "macro_precision": per_class_precision.mean(),
            "macro_recall": per_class_recall.mean(),
            "AUC": float("nan"),
        }

    def binary(self) -> dict:
        """The 2x2 rates (accuracy/precision/recall/f1) — the
        threshold-side half of `binary_metrics` (AUC/AUPR need the full
        score ordering and stay batch-only)."""
        self._ensure(2)
        cm = self.cm
        tn, fp, fn, tp = cm[0, 0], cm[0, 1], cm[1, 0], cm[1, 1]
        out = {
            "accuracy": (tp + tn) / max(cm.sum(), 1),
            "precision": tp / max(tp + fp, 1),
            "recall": tp / max(tp + fn, 1),
        }
        out["f1"] = (2 * out["precision"] * out["recall"]
                     / max(out["precision"] + out["recall"], 1e-12))
        return out


class RegressionState:
    """Mergeable regression sufficient statistics. The label side is
    held as Welford moments (n, mean, M2) and merged with Chan's
    parallel combine — NOT as raw sum(y)/sum(y^2), whose cancellation
    makes the variance (and so r2) garbage for labels with a large mean
    offset (y ~ 1e8 ± 1 has both terms at 1e16 with ulp ~ 2). Residual
    sums are safe raw: mse/mae are the quantities themselves, no
    cancellation. `metrics()` is THE regression finalize kernel
    (mse/rmse/r2/mae), shared by batch and streaming."""

    __slots__ = ("n", "mean_y", "m2_y", "sum_resid2", "sum_abs")

    def __init__(self):
        self.n = 0
        self.mean_y = 0.0
        self.m2_y = 0.0
        self.sum_resid2 = 0.0
        self.sum_abs = 0.0

    def _merge_moments(self, n: int, mean: float, m2: float) -> None:
        from ..utils.stats import merge_moments
        self.n, self.mean_y, self.m2_y = merge_moments(
            self.n, self.mean_y, self.m2_y, n, mean, m2)

    def update(self, y_true, y_pred) -> "RegressionState":
        y = np.asarray(y_true, dtype=np.float64)
        p = np.asarray(y_pred, dtype=np.float64)
        resid = y - p
        if y.size:
            mean = float(y.mean())
            self._merge_moments(int(y.size), mean,
                                float(((y - mean) ** 2).sum()))
        self.sum_resid2 += float((resid ** 2).sum())
        self.sum_abs += float(np.abs(resid).sum())
        return self

    @classmethod
    def from_arrays(cls, y_true, y_pred) -> "RegressionState":
        return cls().update(y_true, y_pred)

    def merge(self, other: "RegressionState") -> "RegressionState":
        self._merge_moments(other.n, other.mean_y, other.m2_y)
        self.sum_resid2 += other.sum_resid2
        self.sum_abs += other.sum_abs
        return self

    def state(self) -> dict:
        return {"n": self.n, "mean_y": self.mean_y, "m2_y": self.m2_y,
                "sum_resid2": self.sum_resid2, "sum_abs": self.sum_abs}

    @classmethod
    def from_state(cls, state: dict) -> "RegressionState":
        st = cls()
        st.n = int(state["n"])
        st.mean_y = float(state["mean_y"])
        st.m2_y = float(state["m2_y"])
        st.sum_resid2 = float(state["sum_resid2"])
        st.sum_abs = float(state["sum_abs"])
        return st

    @property
    def count(self) -> int:
        return self.n

    def metrics(self) -> dict:
        n = max(self.n, 1)
        mse = self.sum_resid2 / n
        var = max(self.m2_y / n, 0.0)
        return {
            "mse": mse,
            "rmse": float(np.sqrt(mse)),
            "r2": 1.0 - mse / max(var, 1e-300),
            "mae": self.sum_abs / n,
        }


def confusion_matrix(y_true, y_pred, n_classes=None):
    return ConfusionState.from_arrays(y_true, y_pred, n_classes).cm


def auc(y_true, scores):
    """Rank-statistic AUC (Mann-Whitney), ties averaged."""
    y_true = np.asarray(y_true)
    scores = np.asarray(scores, dtype=np.float64)
    # average ranks for ties
    uniq, inv, counts = np.unique(scores, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    avg_rank = cum - (counts - 1) / 2.0
    ranks = avg_rank[inv]
    npos = float(y_true.sum())
    nneg = float(len(y_true) - npos)
    if npos == 0 or nneg == 0:
        return 0.5
    return float((ranks[y_true == 1].sum() - npos * (npos + 1) / 2) / (npos * nneg))


def pr_auc(y_true, scores):
    """Area under precision-recall curve (AUPR)."""
    y_true = np.asarray(y_true)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="stable")
    y = y_true[order]
    s = scores[order]
    tp = np.cumsum(y)
    fp = np.cumsum(1 - y)
    npos = y.sum()
    if npos == 0:
        return 0.0
    # evaluate only at distinct-threshold boundaries (tie groups collapse),
    # matching sklearn's average_precision_score convention
    distinct = np.r_[s[1:] != s[:-1], True]
    tp, fp = tp[distinct], fp[distinct]
    precision = tp / np.maximum(tp + fp, 1)
    recall = tp / npos
    d_recall = np.diff(np.concatenate([[0.0], recall]))
    return float((precision * d_recall).sum())


def binary_metrics(y_true, scores, y_pred=None, threshold=0.5):
    y_true = np.asarray(y_true)
    scores = np.asarray(scores)
    if y_pred is None:
        y_pred = (scores >= threshold).astype(float)
    st = ConfusionState.from_arrays(y_true, y_pred, 2)
    out = st.binary()
    # rank statistics need the full score ordering — batch-only, layered
    # on top of the mergeable threshold-side state
    out["AUC"] = auc(y_true, scores)
    out["AUPR"] = pr_auc(y_true, scores)
    return out, st.cm


def multiclass_metrics(y_true, y_pred, n_classes=None):
    """Macro/micro averaged metrics from the paper formulas the reference
    cites (ComputeModelStatistics.scala:330-436) — built from the
    mergeable `ConfusionState` so the batch and streaming paths share one
    finalize kernel."""
    st = ConfusionState.from_arrays(y_true, y_pred, n_classes)
    return st.metrics(), st.cm


def regression_metrics(y_true, y_pred):
    return RegressionState.from_arrays(y_true, y_pred).metrics()


def per_instance_classification(y_true, probabilities):
    """Per-row log-loss (reference: ComputePerInstanceStatistics)."""
    probabilities = np.asarray(probabilities)
    y = np.asarray(y_true).astype(int)
    p = np.clip(probabilities[np.arange(len(y)), y], 1e-15, 1.0)
    return {"log_loss": -np.log(p)}


def per_instance_regression(y_true, y_pred):
    resid = np.asarray(y_true, np.float64) - np.asarray(y_pred, np.float64)
    return {"L1_loss": np.abs(resid), "L2_loss": resid ** 2}


def ndcg_at_k(labels_by_group, scores_by_group, k=10):
    """Mean NDCG@k over query groups (for the ranking evaluator)."""
    vals = []
    for lab, sc in zip(labels_by_group, scores_by_group):
        lab = np.asarray(lab, dtype=np.float64)
        order = np.argsort(-np.asarray(sc))[:k]
        gains = (2 ** lab[order] - 1) / np.log2(np.arange(2, len(order) + 2))
        ideal_order = np.argsort(-lab)[:k]
        ideal = (2 ** lab[ideal_order] - 1) / np.log2(np.arange(2, len(ideal_order) + 2))
        vals.append(gains.sum() / max(ideal.sum(), 1e-12))
    return float(np.mean(vals)) if vals else 0.0
