"""Port parity: Booster introspection (`predict_leaf`, `feature_importances`,
`feature_contributions` on the host and the device, the Saabas fallback),
the estimators' leaf and SHAP columns, `set_best_iteration` and native
model files, against the JAX package on the CPU.

Both packages hold the same trees (a port fit, loaded into the reference
by its model string), so leaf indices and split importances must be
equal, gain importances within rtol 1e-5 (float64 sums of the same f32
gains, another order), and the float64 host TreeSHAP of both packages
within atol 1e-6. The device TreeSHAP is f32 in both packages: within
atol 1e-4 of each other and of the float64 oracle (the reference's
`tests/test_shap_device.py:28`), and its rows sum to the raw score within
the same limit. Inputs include NaN, +-inf, +-1e30 and category ids past
the top bin.
"""
import json

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.models.gbdt import trainer as ref_trainer
from mmlspark_tpu.models.gbdt.booster import Booster as RefBooster
from mmlspark_tpu.models.gbdt.booster import _tree_shap as ref_tree_shap
from mmlspark_tpu.models.gbdt.estimators import (
    GBDTRegressionModel as RefRegressionModel)
from mmlspark_tpu.models.gbdt.estimators import (
    load_native_model as ref_load_native)
from mmlspark_tpu.models.gbdt.shap_device import (
    shap_contributions_device as ref_shap_device)
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.models.gbdt import (BoostParams, GBDTClassifier,
                                            GBDTRegressor, fit_booster,
                                            load_native_model)
from mmlspark_tpu_torch.models.gbdt import shap_device
from mmlspark_tpu_torch.models.gbdt import trainer
from mmlspark_tpu_torch.models.gbdt.booster import _tree_shap
from mmlspark_tpu_torch.models.gbdt.estimators import (
    GBDTClassificationModel, GBDTRegressionModel)

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_SHAP_ATOL = 1e-4
_COMMON = dict(num_iterations=4, max_depth=4, num_leaves=12, max_bin=63,
               min_data_in_leaf=10)
_CAT = (3, 4)


def _data(n=600, seed=0, cat=False):
    """Four numeric columns (two of them categorical ids when `cat`)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5)).astype(np.float32)
    z = x[:, 0] - 0.7 * x[:, 1] + 0.4 * x[:, 2] * x[:, 0]
    if cat:
        ids = [rng.integers(0, k, n) for k in (20, 7)]
        effs = [rng.permutation(np.linspace(-2, 2, k)) for k in (20, 7)]
        z = z + sum(e[c] for e, c in zip(effs, ids))
        x[:, 3], x[:, 4] = ids[0], ids[1]
    y = (z + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    return x, y


def _extreme_rows(x, cat=False):
    """Rows with NaN, +-inf, +-1e30 and, for categorical columns, ids past
    the top bin and negative ones, appended to `x`."""
    odd = np.repeat(x[:8], 1, axis=0).copy()
    vals = [np.nan, np.inf, -np.inf, 1e30, -1e30, np.nan, 0.0, -0.0]
    for i, v in enumerate(vals):
        odd[i, i % 3] = v
    if cat:
        odd[:, 3] = [1000, -5, np.nan, 19, 3.4, 300, 0, 6]
        odd[:, 4] = [7, 8, -1, np.nan, 2, 6, 1000, 0]
    return np.concatenate([x, odd]).astype(np.float32)


def _fit(cat=False, depth=4, **kw):
    x, y = _data(cat=cat)
    params = dict(_COMMON, max_depth=depth, **kw)
    if cat:
        params["categorical_features"] = _CAT
    booster, base, _ = fit_booster(x, y, BoostParams(**params),
                                   device="cpu")
    return booster, base, x


def _ref(booster):
    return RefBooster.load_model_string(booster.save_model_string())


@pytest.mark.parametrize("cat", [False, True])
def test_predict_leaf_matches_reference(cat):
    booster, _, x = _fit(cat=cat)
    if cat:
        assert booster.split_is_cat is not None and booster.split_is_cat.any()
    xs = _extreme_rows(x, cat)
    want = np.asarray(_ref(booster).predict_leaf(xs))
    for backend in ("host", "device"):
        got = booster.predict_leaf(xs, backend=backend, device="cpu")
        assert got.dtype == np.int32 and got.shape == (xs.shape[0],
                                                       booster.n_trees)
        np.testing.assert_array_equal(got, want, err_msg=backend)
    # the leaves' values sum to the raw score (the leaves are resting
    # nodes: each holds its leaf value)
    lv = booster.leaf_value[np.arange(booster.n_trees)[None, :], want]
    np.testing.assert_allclose(lv.sum(1), booster.raw_score(
        xs, backend="host")[:, 0], rtol=1e-6, atol=1e-6)
    # the trainer's descent is the reference's gather descent
    got = trainer.predict_leaf_index(
        torch.as_tensor(xs), torch.as_tensor(booster.split_feature),
        torch.as_tensor(booster.threshold), booster.max_depth,
        *((torch.as_tensor(booster.split_is_cat),
           torch.as_tensor(booster.cat_words)) if cat else ()))
    ref = np.asarray(ref_trainer.predict_leaf_index(
        xs, booster.split_feature, booster.threshold, booster.max_depth,
        *((booster.split_is_cat, booster.cat_words) if cat else ())))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_feature_importances_match_reference():
    booster, _, _ = _fit()
    ref = _ref(booster)
    split = booster.feature_importances("split")
    np.testing.assert_array_equal(split, ref.feature_importances("split"))
    assert split.sum() == (booster.split_feature >= 0).sum()
    np.testing.assert_allclose(booster.feature_importances("gain"),
                               ref.feature_importances("gain"), rtol=1e-5)
    no_gain = booster._replace(gain=None)
    with pytest.warns(UserWarning, match="split counts"):
        got = no_gain.feature_importances("gain")
    np.testing.assert_array_equal(got, split)
    trunc = booster._replace(best_iteration=1)
    np.testing.assert_array_equal(
        trunc.feature_importances("split"),
        _ref(trunc).feature_importances("split"))


@pytest.mark.parametrize("cat", [False, True])
def test_host_tree_shap_matches_reference(cat):
    booster, _, x = _fit(cat=cat)
    xs = _extreme_rows(x[:200], cat)
    for t in range(booster.n_trees):
        kw = ({} if not cat else dict(is_cat=booster.split_is_cat[t],
                                      cat_words=booster.cat_words[t]))
        args = (booster.split_feature[t], booster.threshold[t],
                booster.leaf_value[t], booster.cover[t], xs,
                booster.n_features)
        np.testing.assert_allclose(_tree_shap(*args, **kw),
                                   ref_tree_shap(*args, **kw), atol=1e-6)
    np.testing.assert_allclose(
        booster.feature_contributions(xs, backend="host"),
        _ref(booster).feature_contributions(xs, backend="host"), atol=1e-6)


@pytest.mark.parametrize("cat", [False, True])
def test_device_tree_shap_matches_reference_and_oracle(cat):
    booster, _, x = _fit(cat=cat)
    xs = _extreme_rows(x[:300], cat)
    oracle = booster.feature_contributions(xs, backend="host")
    got = booster.feature_contributions(xs, backend="device", device="cpu")
    assert got.dtype == np.float64 and got.shape == (xs.shape[0], 6)
    ic, cw = ((booster.split_is_cat, booster.cat_words) if cat
              else (None, None))
    ref = ref_shap_device(xs, booster.split_feature, booster.threshold,
                          booster.leaf_value, booster.cover,
                          booster.n_features, booster.max_depth,
                          split_is_cat=ic, cat_words=cw)
    np.testing.assert_allclose(got, ref, atol=_SHAP_ATOL)
    np.testing.assert_allclose(got, oracle, atol=_SHAP_ATOL)
    # local accuracy: each row sums to the raw score
    np.testing.assert_allclose(got.sum(1), booster.raw_score(
        xs, backend="host")[:, 0], atol=_SHAP_ATOL)


def test_device_tree_shap_chunks_and_groups_are_seamless():
    """Row chunks and tree groups change nothing but the f32 order."""
    booster, _, x = _fit(num_iterations=6)
    args = (x, booster.split_feature, booster.threshold, booster.leaf_value,
            booster.cover, booster.n_features, booster.max_depth)
    whole = shap_device.shap_contributions_device(*args, device="cpu")
    chunked = shap_device.shap_contributions_device(*args, row_chunk=77,
                                                    device="cpu")
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6)
    saved = shap_device._GROUP_ELEMENTS
    try:
        shap_device._GROUP_ELEMENTS = 1      # one tree a group
        grouped = shap_device.shap_contributions_device(*args, device="cpu")
    finally:
        shap_device._GROUP_ELEMENTS = saved
    np.testing.assert_allclose(grouped.numpy(), whole.numpy(), atol=1e-5)


def test_deep_booster_refused_by_device_and_auto_takes_host():
    booster, _, x = _fit(depth=9, num_iterations=2, num_leaves=40,
                         min_data_in_leaf=2)
    assert booster.max_depth == 9
    with pytest.raises(ValueError, match="max_depth <= 8"):
        booster.feature_contributions(x[:20], backend="device",
                                      device="cpu")
    # "auto" takes the host oracle here, even without a card
    got = booster.feature_contributions(x[:20], backend="auto")
    np.testing.assert_allclose(
        got, _ref(booster).feature_contributions(x[:20], backend="host"),
        atol=1e-6)


def test_saabas_fallback_without_covers_matches_reference():
    booster, _, x = _fit(cat=True)
    bare = booster._replace(cover=None)
    xs = _extreme_rows(x[:100], cat=True)
    with pytest.raises(ValueError, match="node covers"):
        bare.feature_contributions(xs, backend="device", device="cpu")
    got = bare.feature_contributions(xs, backend="auto")
    np.testing.assert_allclose(
        got, _ref(bare).feature_contributions(xs, backend="host"),
        atol=1e-9)


@pytest.mark.parametrize("est", ["classifier", "regressor"])
def test_estimator_columns_match_reference(est, tmp_path):
    x, y = _data(seed=3)
    kw = dict(_COMMON, leaf_prediction_col="leaves",
              features_shap_col="shap", device="cpu")
    if est == "classifier":
        model = GBDTClassifier(**kw).fit(Table({"features": x, "label": y}))
        cls, ref_cls = GBDTClassificationModel, None
    else:
        y = y + 0.5 * x[:, 0]
        model = GBDTRegressor(**kw).fit(Table({"features": x, "label": y}))
        cls, ref_cls = GBDTRegressionModel, RefRegressionModel
    assert model._init_score != 0.0
    out = model.transform(Table({"features": x}))
    booster = model.booster
    np.testing.assert_array_equal(out["leaves"], np.asarray(
        _ref(booster).predict_leaf(x)))
    shap = np.asarray(out["shap"])
    raw = booster.raw_score(x, model._init_score, backend="host")[:, 0]
    # the init score rides the bias column: rows sum to the prediction
    np.testing.assert_allclose(shap.sum(1), raw, atol=_SHAP_ATOL)
    np.testing.assert_allclose(
        shap[:, -1] - model._init_score,
        _ref(booster).feature_contributions(x, backend="host")[:, -1],
        atol=_SHAP_ATOL)
    # native files: written by either package, loaded by the other
    path = str(tmp_path / "port.json")
    model.save_native_model(path)
    payload = json.loads(open(path).read())
    assert payload["init_score"] == model._init_score
    ref_model = ref_load_native(path) if ref_cls is None else \
        ref_load_native(path, ref_cls)
    np.testing.assert_array_equal(
        ref_model.booster.raw_score(x, ref_model._init_score,
                                    backend="host"),
        booster.raw_score(x, model._init_score, backend="host"))
    ref_path = str(tmp_path / "ref.json")
    ref_model.save_native_model(ref_path)
    back = load_native_model(ref_path, cls)
    assert isinstance(back, cls)
    assert back._init_score == model._init_score
    np.testing.assert_array_equal(
        back.booster.raw_score(x, back._init_score, backend="host"),
        booster.raw_score(x, model._init_score, backend="host"))
    back.set(device="cpu")
    np.testing.assert_array_equal(
        np.asarray(back.transform(Table({"features": x}))["prediction"]),
        np.asarray(out["prediction"]))


def test_set_best_iteration_matches_reference():
    x, y = _data(seed=5)
    model = GBDTClassifier(device="cpu", **_COMMON).fit(
        Table({"features": x, "label": y}))
    ref_model = RefRegressionModel(booster=_ref(model.booster),
                                   init_score=model._init_score)
    assert model.set_best_iteration(1) is model
    ref_model.set_best_iteration(1)
    assert model.booster.best_iteration == 1
    got = model.transform(Table({"features": x}))["raw_prediction"][:, 0]
    want = ref_model.transform(RefTable({"features": x}))["prediction"]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        model.feature_importances("split"),
        ref_model.feature_importances("split"))
    assert model.feature_importances("split").sum() == (
        model.booster.split_feature[:2] >= 0).sum()
