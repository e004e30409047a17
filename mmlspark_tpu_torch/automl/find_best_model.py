"""FindBestModel: evaluate fitted models on one metric, keep the best
(reference: automl/FindBestModel.scala — emits best model + EvaluationResults).
A copy of `mmlspark_tpu/automl/find_best_model.py` (host code).
"""
from __future__ import annotations

import numpy as np

from ..core import Estimator, Model, Param, Table


class FindBestModel(Estimator):
    models = Param("models", "fitted Transformer candidates", None)
    evaluation_metric = Param("evaluation_metric", "metric name", "AUC")
    evaluator = Param("evaluator", "Evaluator instance (overrides metric)", None)

    def _make_evaluator(self):
        if self.evaluator is not None:
            return self.evaluator
        metric = self.evaluation_metric
        if metric in ("mse", "rmse", "mae", "r2"):
            from ..train import RegressionEvaluator
            return RegressionEvaluator(metric=metric)
        from ..train import ClassificationEvaluator
        return ClassificationEvaluator(metric=metric)

    def _fit(self, t: Table) -> "BestModel":
        evaluator = self._make_evaluator()
        larger = evaluator.is_larger_better
        scores = []
        for m in self.models or []:
            scores.append(float(evaluator.evaluate(m.transform(t))))
        order = np.argsort(scores)
        best_i = int(order[-1] if larger else order[0])
        out = BestModel()
        out._best_model = self.models[best_i]
        out._scores = scores
        out._metric = self.evaluation_metric
        return out


class BestModel(Model):
    best_model_stage = Param("best_model_stage", "persisted best model", None)

    def __init__(self, **kw):
        super().__init__(**kw)
        self._best_model = None
        self._scores = []
        self._metric = None

    @property
    def best_model(self):
        return self._best_model

    def get_evaluation_results(self) -> Table:
        return Table({"model": np.arange(len(self._scores)),
                      self._metric or "metric": np.asarray(self._scores)})

    def _prepare_save(self):
        self.set(best_model_stage=self._best_model)

    def _finish_load(self):
        self._best_model = self.get("best_model_stage")

    def _transform(self, t: Table) -> Table:
        return self._best_model.transform(t)
