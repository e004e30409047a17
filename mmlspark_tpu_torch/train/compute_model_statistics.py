"""ComputeModelStatistics / ComputePerInstanceStatistics transformers
(reference: train/ComputeModelStatistics.scala:58-470, ComputePerInstanceStatistics).

Consume a scored Table (label + scores/probabilities/prediction columns) and
emit a one-row metrics Table (plus confusion matrix accessor) or per-row
statistics columns.

The metric math lives in `train.metrics`' mergeable state cores
(`ConfusionState`/`RegressionState`); the streaming evaluator on the
serving stream (`telemetry.quality.StreamingEvaluator`) folds the SAME
states, so this batch transformer and online evaluation share one
finalize kernel by construction.

A copy of `mmlspark_tpu/train/compute_model_statistics.py` (host numpy).
"""
from __future__ import annotations

import logging

import numpy as np

from ..core import (Transformer, Param, Table, HasLabelCol, HasScoresCol,
                    HasScoredLabelsCol, Evaluator, one_of)
from . import metrics as M

_logger = logging.getLogger("mmlspark_tpu_torch.metrics")


class ComputeModelStatistics(Transformer, HasLabelCol, HasScoredLabelsCol,
                             HasScoresCol):
    evaluation_metric = Param(
        "evaluation_metric", "classification|regression|auto", "auto",
        validator=one_of("auto", "classification", "regression"))
    scores_col = Param("scores_col", "probability/score column", None)
    scored_labels_col = Param("scored_labels_col", "predicted label column",
                              "prediction")

    def _resolve_kind(self, t: Table) -> str:
        kind = self.evaluation_metric
        if kind != "auto":
            return kind
        y = np.asarray(t[self.label_col])
        uniq = np.unique(y[~np.isnan(y.astype(np.float64))] if
                         np.issubdtype(y.dtype, np.floating) else y)
        is_int_like = np.issubdtype(y.dtype, np.integer) or (
            np.issubdtype(y.dtype, np.floating)
            and np.allclose(uniq, np.round(uniq)))
        return "classification" if (is_int_like and uniq.size <= 100) else "regression"

    def _transform(self, t: Table) -> Table:
        kind = self._resolve_kind(t)
        y = np.asarray(t[self.label_col], dtype=np.float64)
        pred_col = self.scored_labels_col
        if kind == "classification":
            pred = np.asarray(t[pred_col], dtype=np.float64)
            n_classes = int(max(y.max(), pred.max())) + 1
            scores = None
            scol = self.scores_col
            if scol is None:
                for cand in ("probabilities", "scores", "raw_prediction"):
                    if cand in t:
                        scol = cand
                        break
            if scol and scol in t:
                s = np.asarray(t[scol])
                scores = s[:, 1] if s.ndim == 2 and s.shape[1] == 2 else s
            if n_classes <= 2 and scores is not None and scores.ndim == 1:
                vals, cm = M.binary_metrics(y, scores, y_pred=pred)
            else:
                vals, cm = M.multiclass_metrics(y, pred, n_classes)
            self._confusion_matrix = cm
        else:
            pred = np.asarray(t[pred_col], dtype=np.float64)
            vals = M.regression_metrics(y, pred)
            self._confusion_matrix = None
        # MetricsLogger analog (ComputeModelStatistics.scala:473)
        _logger.info("model statistics: %s", vals)
        return Table({k: np.asarray([v]) for k, v in vals.items()})

    @property
    def confusion_matrix(self):
        return self._confusion_matrix


class ComputePerInstanceStatistics(Transformer, HasLabelCol, HasScoredLabelsCol):
    evaluation_metric = Param(
        "evaluation_metric", "classification|regression|auto", "auto",
        validator=one_of("auto", "classification", "regression"))
    probabilities_col = Param("probabilities_col", "probability column",
                              "probabilities")
    scored_labels_col = Param("scored_labels_col", "predicted label column",
                              "prediction")

    def _transform(self, t: Table) -> Table:
        y = np.asarray(t[self.label_col], dtype=np.float64)
        kind = self.evaluation_metric
        if kind == "auto":
            kind = ("classification"
                    if self.probabilities_col in t else "regression")
        if kind == "classification":
            cols = M.per_instance_classification(y, t[self.probabilities_col])
        else:
            cols = M.per_instance_regression(y, t[self.scored_labels_col])
        return t.with_columns(cols)


class ClassificationEvaluator(Evaluator, HasLabelCol):
    """Scores a transformed table by one classification metric (used by
    TuneHyperparameters / FindBestModel)."""
    metric = Param("metric", "AUC|accuracy|precision|recall|f1", "AUC")
    scores_col = Param("scores_col", "probability column", "probabilities")
    scored_labels_col = Param("scored_labels_col", "prediction column", "prediction")

    def evaluate(self, t: Table) -> float:
        y = np.asarray(t[self.label_col], dtype=np.float64)
        pred = np.asarray(t[self.scored_labels_col], dtype=np.float64)
        scores = None
        if self.scores_col in t:
            s = np.asarray(t[self.scores_col])
            scores = s[:, 1] if s.ndim == 2 and s.shape[1] == 2 else None
        if scores is not None and len(np.unique(y)) <= 2:
            vals, _ = M.binary_metrics(y, scores, y_pred=pred)
        else:
            vals, _ = M.multiclass_metrics(y, pred)
        v = vals.get(self.metric)
        if v is None or (isinstance(v, float) and np.isnan(v)):
            v = vals["accuracy"] if self.metric == "AUC" else vals[self.metric]
        return float(v)


class RegressionEvaluator(Evaluator, HasLabelCol):
    metric = Param("metric", "mse|rmse|r2|mae", "rmse")
    scored_labels_col = Param("scored_labels_col", "prediction column", "prediction")

    def evaluate(self, t: Table) -> float:
        vals = M.regression_metrics(np.asarray(t[self.label_col]),
                                    np.asarray(t[self.scored_labels_col]))
        return float(vals[self.metric])

    @property
    def is_larger_better(self) -> bool:
        return self.metric == "r2"
