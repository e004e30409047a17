"""Port parity: `train/` (TrainClassifier, TrainRegressor,
ComputeModelStatistics, ComputePerInstanceStatistics, the evaluators) and
`automl/` (the hyperparameter spaces, TuneHyperparameters,
FindBestModel).

The same seeded tables go through both packages, JAX on the CPU and the
port with `device="cpu"`. Tolerances:
- featurizers, label indexers, candidate lists and CV folds equal the
  reference's exactly (numpy's `default_rng(seed)` on both sides);
- linear inner models within `_RTOL` of the reference's largest weight
  (as tests/test_torch_linear.py), probabilities within `_PROBA_TOL`;
- statistics of one scored table equal exactly (host numpy on both
  sides);
- tuning scores within `_SCORE_TOL` (AUC of fits that differ at f32
  rounding; GBDT's histograms add in another order) and the same best
  candidate; the port's scores equal bit for bit across `parallelism`.
"""
import numpy as np
import torch

from mmlspark_tpu.automl import FindBestModel as RefFindBest
from mmlspark_tpu.automl import RandomSpace as RefRandomSpace
from mmlspark_tpu.automl import TuneHyperparameters as RefTune
from mmlspark_tpu.automl.hyperparam import (DiscreteHyperParam as RefDiscrete,
                                            GridSpace as RefGrid,
                                            RangeHyperParam as RefRange)
from mmlspark_tpu.core import Estimator as RefEstimator
from mmlspark_tpu.core import Model as RefModel
from mmlspark_tpu.core import Param as RefParam
from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.models.gbdt import GBDTClassifier as RefGBDT
from mmlspark_tpu.models.linear import LinearRegression as RefLinReg
from mmlspark_tpu.models.linear import LogisticRegression as RefLogReg
from mmlspark_tpu.train import ClassificationEvaluator as RefClsEvaluator
from mmlspark_tpu.train import ComputeModelStatistics as RefStats
from mmlspark_tpu.train import ComputePerInstanceStatistics as RefPerRow
from mmlspark_tpu.train import TrainClassifier as RefTrainClassifier
from mmlspark_tpu.train import RegressionEvaluator as RefRegEvaluator
from mmlspark_tpu.train import TrainRegressor as RefTrainRegressor
from mmlspark_tpu_torch.automl import (DiscreteHyperParam, FindBestModel,
                                       GridSpace, HyperparamBuilder,
                                       RandomSpace, RangeHyperParam,
                                       TuneHyperparameters)
from mmlspark_tpu_torch.core import Estimator, Model, Param, Table
from mmlspark_tpu_torch.core.serialize import load_stage, save_stage
from mmlspark_tpu_torch.models.gbdt import GBDTClassifier
from mmlspark_tpu_torch.models.linear import (LinearRegression,
                                              LogisticRegression)
from mmlspark_tpu_torch.train import (ClassificationEvaluator,
                                      ComputeModelStatistics,
                                      ComputePerInstanceStatistics,
                                      RegressionEvaluator, TrainClassifier,
                                      TrainRegressor, trained_from_reference)

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_RTOL = 1e-5
_PROBA_TOL = 1e-5
_SCORE_TOL = 1e-3
_N = 1800          # three equal folds: one traced shape per fold size
_GBDT = dict(num_iterations=8, num_leaves=7, max_depth=3,
             min_data_in_leaf=5)


def _table(seed=0, n=_N):
    """Mixed columns and a string label from a logistic truth."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n)
    b = rng.normal(size=n)
    b[rng.random(n) < 0.05] = np.nan
    cat = rng.choice(["red", "green", "blue", "grey"], n)
    shift = np.select([cat == "red", cat == "green"], [1.0, -1.0], 0.0)
    z = 1.5 * a - np.nan_to_num(b) + shift
    y = np.where(rng.random(n) < 1 / (1 + np.exp(-z)), ">50K", "<=50K")
    return {"a": a, "b": b, "cat": cat, "label": y,
            "target": z + 0.1 * rng.normal(size=n)}


def _both(cols):
    return RefTable(dict(cols)), Table(dict(cols))


def _assert_featurizers_equal(ref, got, rt, pt):
    r, p = ref.transform(rt), got.transform(pt)
    for c in r.columns:
        assert np.asarray(r[c]).tobytes() == np.asarray(p[c]).tobytes(), c


def test_train_classifier_string_labels_matches_reference(tmp_path):
    cols = _table()
    cols.pop("target")
    rt, pt = _both(cols)
    ref = RefTrainClassifier().fit(rt)
    got = TrainClassifier(device="cpu").fit(pt)
    np.testing.assert_array_equal(got._label_model.levels,
                                  ref._label_model.levels)
    _assert_featurizers_equal(ref._featurizer, got._featurizer,
                              ref._label_model.transform(rt),
                              got._label_model.transform(pt))
    scale = np.abs(ref.inner_model._w).max()
    np.testing.assert_allclose(got.inner_model._w, ref.inner_model._w,
                               rtol=0, atol=_RTOL * scale)
    rout, pout = ref.transform(rt), got.transform(pt)
    np.testing.assert_allclose(pout["probabilities"],
                               np.asarray(rout["probabilities"]),
                               rtol=0, atol=_PROBA_TOL)
    np.testing.assert_array_equal(pout["scored_labels"],
                                  np.asarray(rout["scored_labels"]))
    assert "__train_features" not in pout
    save_stage(got, str(tmp_path / "tc"))
    back = load_stage(str(tmp_path / "tc"))
    np.testing.assert_array_equal(back.transform(pt)["probabilities"],
                                  pout["probabilities"])
    # the reference's fitted composite carried across scores as it does
    carried = trained_from_reference(ref, device="cpu")
    cout = carried.transform(pt)
    np.testing.assert_array_equal(cout["probabilities"],
                                  np.asarray(rout["probabilities"]))
    np.testing.assert_array_equal(cout["scored_labels"],
                                  np.asarray(rout["scored_labels"]))


def test_train_classifier_gbdt_and_regressor_match_reference():
    cols = _table()
    target = cols.pop("target")
    rt, pt = _both(cols)
    ref = RefTrainClassifier(model=RefGBDT(**_GBDT)).fit(rt)
    got = TrainClassifier(model=GBDTClassifier(device="cpu", **_GBDT)
                          ).fit(pt)
    rout, pout = ref.transform(rt), got.transform(pt)
    agree = np.mean(pout["scored_labels"] == np.asarray(rout["scored_labels"]))
    assert agree > 0.99
    carried = trained_from_reference(ref, device="cpu")
    np.testing.assert_allclose(carried.transform(pt)["probabilities"],
                               np.asarray(rout["probabilities"]), rtol=0,
                               atol=1e-6)
    reg_cols = dict(cols, label=target)
    rt, pt = _both(reg_cols)
    # the one-hot block and the bias are collinear: the normal solver
    # needs L2 here (numpy's solve reports the singular system, torch's
    # LU may not)
    for ref_inner, inner in ((RefLinReg(reg_param=0.1),
                              LinearRegression(reg_param=0.1)),
                             (RefLinReg(solver="sgd", max_iter=50),
                              LinearRegression(solver="sgd", max_iter=50))):
        ref = RefTrainRegressor(model=ref_inner).fit(rt)
        got = TrainRegressor(model=inner, device="cpu").fit(pt)
        scale = np.abs(ref.inner_model._w).max()
        np.testing.assert_allclose(got.inner_model._w, ref.inner_model._w,
                                   rtol=0, atol=_RTOL * scale)
        r, p = ref.transform(rt), got.transform(pt)
        np.testing.assert_allclose(p["scored_labels"],
                                   np.asarray(r["scored_labels"]),
                                   rtol=0, atol=_RTOL * scale * 10)
    out = trained_from_reference(ref, device="cpu").transform(pt)
    np.testing.assert_array_equal(out["prediction"],
                                  np.asarray(r["prediction"]))


def test_statistics_and_evaluators_match_reference():
    rng = np.random.default_rng(4)
    n = 600
    y = rng.integers(0, 2, n).astype(np.float64)
    p1 = np.clip(0.3 * y + 0.7 * rng.random(n), 0, 1)
    proba = np.stack([1 - p1, p1], 1)
    y3 = rng.integers(0, 3, n).astype(np.float64)
    cases = [
        {"label": y, "probabilities": proba,
         "prediction": (p1 > 0.5).astype(np.float64)},
        {"label": y3, "prediction": (y3 + (rng.random(n) < 0.2)) % 3},
        {"label": rng.normal(size=n) * 10,
         "prediction": rng.normal(size=n) * 10},
    ]
    for cols in cases:
        rt, pt = _both(cols)
        for kind in ("auto", "classification", "regression"):
            if kind == "classification" and cols is cases[2]:
                continue
            r = RefStats(evaluation_metric=kind)
            p = ComputeModelStatistics(evaluation_metric=kind)
            rs, ps = r.transform(rt), p.transform(pt)
            assert rs.columns == ps.columns
            for c in rs.columns:
                np.testing.assert_array_equal(ps[c], np.asarray(rs[c]))
            if r.confusion_matrix is not None:
                np.testing.assert_array_equal(p.confusion_matrix,
                                              r.confusion_matrix)
    rt, pt = _both(cases[0])
    r, p = RefPerRow().transform(rt), ComputePerInstanceStatistics(
        ).transform(pt)
    for c in r.columns:
        np.testing.assert_array_equal(p[c], np.asarray(r[c]))
    for metric in ("AUC", "accuracy", "precision", "recall"):
        assert ClassificationEvaluator(metric=metric).evaluate(pt) == \
            RefClsEvaluator(metric=metric).evaluate(rt)
    rt, pt = _both(cases[2])
    for metric in ("mse", "rmse", "r2", "mae"):
        ev = RegressionEvaluator(metric=metric)
        assert ev.is_larger_better == (metric == "r2")
        assert ev.evaluate(pt) == \
            RefRegEvaluator(metric=metric).evaluate(rt)


def _space(ref: bool):
    d, r = (RefDiscrete, RefRange) if ref else (DiscreteHyperParam,
                                                RangeHyperParam)
    return {"learning_rate": r(0.01, 0.3, log=True),
            "reg_param": d([0.0, 1e-3, 1e-2]),
            "num_leaves": d([3, 7]),
            "max_iter": r(20, 60, is_int=True)}


def test_spaces_draw_the_reference_s_candidates():
    for seed in (0, 11):
        want = list(RefRandomSpace(_space(True), seed).param_maps(6))
        assert list(RandomSpace(_space(False), seed).param_maps(6)) == want
    small = {"a": DiscreteHyperParam([1, 2]), "b": RangeHyperParam(0, 1)}
    ref_small = {"a": RefDiscrete([1, 2]), "b": RefRange(0, 1)}
    assert list(GridSpace(small).param_maps()) == \
        list(RefGrid(ref_small).param_maps())
    built = HyperparamBuilder().add_hyperparam("a", small["a"]).build()
    assert built == {"a": small["a"]}


_SEEN = {}


class _RefRecorder(RefEstimator):
    alpha = RefParam("alpha", "score scale", 1.0)

    def _fit(self, t):
        _SEEN.setdefault("ref", []).append(np.asarray(t["row"]).copy())
        m = _RefScaled()
        m.alpha = self.alpha
        return m


class _RefScaled(RefModel):
    def _transform(self, t):
        p1 = 1 / (1 + np.exp(-self.alpha * np.asarray(t["a"])))
        return (t.with_column("probabilities", np.stack([1 - p1, p1], 1))
                 .with_column("prediction", (p1 > 0.5).astype(np.float64)))


class _Recorder(Estimator):
    alpha = Param("alpha", "score scale", 1.0)

    def _fit(self, t):
        _SEEN.setdefault("port", []).append(np.asarray(t["row"]).copy())
        m = _Scaled()
        m.alpha = self.alpha
        return m


class _Scaled(Model):
    def _transform(self, t):
        p1 = 1 / (1 + np.exp(-self.alpha * np.asarray(t["a"])))
        return (t.with_column("probabilities", np.stack([1 - p1, p1], 1))
                 .with_column("prediction", (p1 > 0.5).astype(np.float64)))


def test_tune_folds_and_candidates_equal_the_reference_s():
    rng = np.random.default_rng(8)
    n = 301
    cols = {"row": np.arange(n), "a": rng.normal(size=n),
            "label": rng.integers(0, 2, n).astype(np.float64)}
    rt, pt = _both(cols)
    _SEEN.clear()
    kw = dict(number_of_folds=4, number_of_iterations=3, seed=5,
              parallelism=1)
    ref = RefTune(models=[_RefRecorder()], evaluation_metric="accuracy",
                  hyperparam_space={"alpha": RefRange(-2.0, 2.0)}, **kw
                  ).fit(rt)
    got = TuneHyperparameters(
        models=[_Recorder()], evaluation_metric="accuracy",
        hyperparam_space={"alpha": RangeHyperParam(-2.0, 2.0)}, **kw).fit(pt)
    assert len(_SEEN["port"]) == len(_SEEN["ref"]) == 3 * 4 + 1
    for a, b in zip(_SEEN["port"], _SEEN["ref"]):
        np.testing.assert_array_equal(a, b)
    assert got._all_scores == ref._all_scores
    assert got._best_params == ref._best_params
    assert got.best_metric == ref.best_metric


def test_tune_and_find_best_over_lr_and_gbdt_match_reference():
    cols = _table(seed=3)
    cols.pop("target")
    rt, pt = _both(cols)
    ref_tc = RefTrainClassifier().fit(rt)
    ft_ref = ref_tc._featurizer.transform(ref_tc._label_model.transform(rt)
                                          .drop("label").rename(
                                              {"__label_idx": "label"}))
    ft = Table({c: np.asarray(ft_ref[c]) for c in ("__train_features",
                                                    "label")})
    ft_ref = RefTable({c: np.asarray(ft_ref[c]) for c in
                       ("__train_features", "label")})
    common = dict(features_col="__train_features")
    kw = dict(number_of_folds=3, number_of_iterations=2, seed=2)
    ref = RefTune(models=[RefLogReg(**common), RefGBDT(**common, **_GBDT)],
                  hyperparam_space=_space(True), **kw).fit(ft_ref)
    runs = {}
    for par in (1, 4):
        runs[par] = TuneHyperparameters(
            models=[LogisticRegression(device="cpu", **common),
                    GBDTClassifier(device="cpu", **common, **_GBDT)],
            hyperparam_space=_space(False), parallelism=par, **kw).fit(ft)
    got = runs[1]
    assert [pm for pm, _ in got._all_scores] == \
        [pm for pm, _ in ref._all_scores]
    np.testing.assert_allclose([s for _, s in got._all_scores],
                               [s for _, s in ref._all_scores], rtol=0,
                               atol=_SCORE_TOL)
    assert runs[4]._all_scores == got._all_scores
    assert got._best_params == ref._best_params
    assert type(got.best_model).__name__ == type(ref.best_model).__name__
    # FindBestModel over the fitted candidates picks the same one
    fits_ref = [RefLogReg(max_iter=k, **common).fit(ft_ref)
                for k in (2, 40)] + [RefGBDT(**common, **_GBDT).fit(ft_ref)]
    fits = [LogisticRegression(max_iter=k, device="cpu", **common).fit(ft)
            for k in (2, 40)] + [GBDTClassifier(device="cpu", **common,
                                                **_GBDT).fit(ft)]
    best_ref = RefFindBest(models=fits_ref).fit(ft_ref)
    best = FindBestModel(models=fits).fit(ft)
    np.testing.assert_allclose(best._scores, best_ref._scores, rtol=0,
                               atol=_SCORE_TOL)
    assert fits.index(best.best_model) == fits_ref.index(best_ref.best_model)
    res = best.get_evaluation_results()
    np.testing.assert_array_equal(res["AUC"], np.asarray(best._scores))
