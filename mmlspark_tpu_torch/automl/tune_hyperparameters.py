"""TuneHyperparameters: random/grid search with k-fold CV and thread-pool
parallel evaluation (reference: automl/TuneHyperparameters.scala:34-233 —
the ExecutorService-parallel fit at :128-200 maps to a ThreadPoolExecutor).

A copy of `mmlspark_tpu/automl/tune_hyperparameters.py` (host code; the
candidates fit and score on their own devices). The folds and the random
draws come from numpy's `default_rng(seed)`, so the candidate lists and
the folds are the reference's. On one card the pool's threads share the
card's stream and the GIL: `parallelism` changes how the fits overlap,
not what each computes.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..core import Estimator, Model, Param, Table, one_of
from .hyperparam import GridSpace, RandomSpace


class TuneHyperparameters(Estimator):
    models = Param("models", "candidate estimators", None)
    hyperparam_space = Param("hyperparam_space",
                             "dict name->HyperParam, or list of (est_idx, space)", None)
    evaluation_metric = Param("evaluation_metric", "metric name for the evaluator", "AUC")
    evaluator = Param("evaluator", "Evaluator instance (overrides metric)", None)
    number_of_folds = Param("number_of_folds", "k-fold CV folds", 3)
    parallelism = Param("parallelism", "concurrent model fits", 4)
    search_mode = Param("search_mode", "random|grid", "random",
                        validator=one_of("random", "grid"))
    number_of_iterations = Param("number_of_iterations",
                                 "random-search draws per model", 10)
    seed = Param("seed", "sampling seed", 0)

    def _make_evaluator(self):
        if self.evaluator is not None:
            return self.evaluator
        metric = self.evaluation_metric
        if metric in ("mse", "rmse", "mae", "r2"):
            from ..train import RegressionEvaluator
            return RegressionEvaluator(metric=metric)
        from ..train import ClassificationEvaluator
        return ClassificationEvaluator(metric=metric)

    def _candidates(self):
        models = self.models or []
        space = self.hyperparam_space or {}
        cands = []
        for est in models:
            if self.search_mode == "grid":
                maps = list(GridSpace(space).param_maps())
            else:
                maps = list(RandomSpace(space, self.seed)
                            .param_maps(self.number_of_iterations))
            for pm in (maps or [{}]):
                valid = {k: v for k, v in pm.items() if est.has_param(k)}
                cands.append((est, valid))
        return cands

    def _fit(self, t: Table) -> "TuneHyperparametersModel":
        evaluator = self._make_evaluator()
        larger = evaluator.is_larger_better
        k = max(2, self.number_of_folds)
        n = len(t)
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n)
        folds = np.array_split(perm, k)
        # each fold's (train, test) tables, cut once for every candidate
        # (the reference cuts them per candidate: the same rows)
        splits = []
        for i in range(k):
            train_idx = np.concatenate([folds[j] for j in range(k) if j != i])
            splits.append((t.filter(np.isin(np.arange(n), train_idx)),
                           t.filter(np.isin(np.arange(n), folds[i]))))

        def run(cand):
            est, pm = cand
            scores = []
            for tr, te in splits:
                model = est.copy(pm).fit(tr)
                scores.append(evaluator.evaluate(model.transform(te)))
            return float(np.mean(scores))

        cands = self._candidates()
        with ThreadPoolExecutor(max_workers=max(1, self.parallelism)) as pool:
            scores = list(pool.map(run, cands))
        order = np.argsort(scores)
        best_i = int(order[-1] if larger else order[0])
        best_est, best_pm = cands[best_i]
        best_model = best_est.copy(best_pm).fit(t)

        out = TuneHyperparametersModel()
        out._best_model = best_model
        out._best_metric = scores[best_i]
        out._best_params = best_pm
        out._all_scores = list(zip([pm for _, pm in cands], scores))
        return out


class TuneHyperparametersModel(Model):
    best_model_stage = Param("best_model_stage", "persisted best model", None)

    def __init__(self, **kw):
        super().__init__(**kw)
        self._best_model = None
        self._best_metric = None
        self._best_params = None
        self._all_scores = []

    @property
    def best_model(self):
        return self._best_model

    @property
    def best_metric(self):
        return self._best_metric

    def get_best_model_info(self) -> str:
        return f"params={self._best_params} metric={self._best_metric}"

    def _prepare_save(self):
        self.set(best_model_stage=self._best_model)

    def _finish_load(self):
        self._best_model = self.get("best_model_stage")

    def _transform(self, t: Table) -> Table:
        return self._best_model.transform(t)
