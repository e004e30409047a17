"""Port parity: the boosting loop, `Booster` and the estimators
(`mmlspark_tpu_torch.models.gbdt`) against the JAX package, on the CPU.

Fits use continuous features (2000 x 8, 64 bins) so that no two
distinct splits tie: trees must be equal and margins allclose at f32
summation tolerance (rtol 1e-4, atol 1e-4 after 8 iterations, since
histogram, leaf and margin sums add in another order). One tie remains
by construction: where a node's rows leave bin b+1 empty, thresholds b
and b+1 are the same split, and f32 rounding of the sibling-subtracted
histograms picks either. Such nodes must split the same feature and send
every training row to the same leaf; everywhere else split bins are
equal. Model strings cross between the packages and score
bit-identically on the host path.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.models.gbdt import GBDTClassifier as RefClassifier
from mmlspark_tpu.models.gbdt.booster import Booster as RefBooster
from mmlspark_tpu.models.gbdt.boosting import BoostParams as RefParams
from mmlspark_tpu.models.gbdt.boosting import fit_booster as ref_fit
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.models.gbdt import (Booster, BoostParams,
                                            GBDTClassifier, GBDTRegressor,
                                            fit_booster)
from mmlspark_tpu_torch.models.gbdt.convert import (bin_mapper_from_reference,
                                                    booster_from_reference)
from mmlspark_tpu_torch.ops.binning import apply_bins, fit_bins

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_TOL = dict(rtol=1e-4, atol=1e-4)
_COMMON = dict(num_iterations=8, max_depth=4, num_leaves=15, max_bin=63,
               min_data_in_leaf=20)


def _data(objective, n=2000, f=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    z = x @ rng.normal(size=f) + 0.3 * rng.normal(size=n)
    if objective == "binary":
        y = (z > 0).astype(np.float32)
    elif objective == "multiclass":
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float32)
    else:
        y = z.astype(np.float32)
    return x, y


def _resting_leaves(bins, sf, sb, depth):
    node = np.zeros(bins.shape[0], np.int64)
    rows = np.arange(bins.shape[0])
    for _ in range(depth):
        f = sf[node]
        go_left = bins[rows, np.clip(f, 0, bins.shape[1] - 1)] <= sb[node]
        node = np.where(f < 0, node,
                        np.where(go_left, 2 * node + 1, 2 * node + 2))
    return node


def _assert_same_model(a, b, bins=None):
    """Equal trees; with the training `bins`, a split bin may differ only
    where both thresholds send every training row to the same leaf."""
    np.testing.assert_array_equal(a.split_feature, b.split_feature)
    same = a.split_bin == b.split_bin
    if bins is None:
        assert same.all()
    else:
        assert same.mean() > 0.95
        for t in np.nonzero(~same.all(axis=1))[0]:
            np.testing.assert_array_equal(
                _resting_leaves(bins, a.split_feature[t], a.split_bin[t],
                                a.max_depth),
                _resting_leaves(bins, b.split_feature[t], b.split_bin[t],
                                b.max_depth), err_msg=f"tree {t}")
    np.testing.assert_array_equal(a.threshold[same], b.threshold[same])
    np.testing.assert_array_equal(a.tree_class, b.tree_class)
    np.testing.assert_allclose(a.leaf_value, b.leaf_value, **_TOL)
    assert a.best_iteration == b.best_iteration
    assert (a.max_depth, a.n_classes, a.objective, a.n_features) == \
        (b.max_depth, b.n_classes, b.objective, b.n_features)


@pytest.mark.parametrize("case", ["binary", "l2_weighted_valid",
                                  "multiclass"])
def test_fit_booster_matches_reference(case):
    objective = {"l2_weighted_valid": "regression"}.get(case, case)
    x, y = _data(objective)
    kw = dict(_COMMON, objective=objective)
    fit_kw = {}
    if case == "multiclass":
        kw.update(num_class=3, num_iterations=4)
    if case == "l2_weighted_valid":
        kw.update(early_stopping_round=3)
        w = np.random.default_rng(5).uniform(0.5, 2.0, len(y))
        vx, vy = _data(objective, n=500, seed=9)
        fit_kw = dict(weights=w.astype(np.float32), valid=(vx, vy))
    ref_b, ref_base, ref_hist = ref_fit(x, y, RefParams(**kw), **fit_kw)
    got_b, got_base, got_hist = fit_booster(x, y, BoostParams(**kw),
                                            device="cpu", **fit_kw)
    assert got_base == ref_base
    assert got_b.n_trees == ref_b.n_trees > 0
    _assert_same_model(got_b, ref_b,
                       apply_bins(fit_bins(x, max_bin=63, seed=0), x))
    np.testing.assert_allclose(got_hist, ref_hist, rtol=1e-4)
    np.testing.assert_allclose(
        got_b.raw_score(x, got_base, backend="device", device="cpu"),
        ref_b.raw_score(x, ref_base), **_TOL)


def test_prebinned_and_init_scores_match_reference():
    from mmlspark_tpu.ops import binning as ref_binning
    from mmlspark_tpu_torch.ops import binning as port_binning
    x, y = _data("binary", seed=2)
    init = np.random.default_rng(3).normal(scale=0.1, size=len(y))
    kw = dict(_COMMON, objective="binary", num_iterations=3)
    mapper = ref_binning.fit_bins(x, max_bin=63, seed=0)
    ref_b, _, _ = ref_fit(
        x, y, RefParams(**kw), init_scores=init,
        prebinned=(mapper, ref_binning.apply_bins_device(mapper, x)))
    bins = port_binning.apply_bins_device(mapper, x, device="cpu")
    got_b, base, _ = fit_booster(
        x, y, BoostParams(**kw), init_scores=init, device="cpu",
        prebinned=(mapper, bins, torch.as_tensor(y)))
    assert base == 0.0
    _assert_same_model(got_b, ref_b, bins.numpy())


@pytest.fixture(scope="module")
def ref_booster():
    x, y = _data("binary", seed=4)
    b, base, _ = ref_fit(x, y, RefParams(**dict(_COMMON, objective="binary",
                                                num_iterations=5)))
    return b, base, x


def test_reference_model_string_loads_in_port(ref_booster):
    ref_b, base, x = ref_booster
    xn = x.copy()
    xn[::7, 2] = np.nan
    for got in (Booster.load_model_string(ref_b.save_model_string()),
                booster_from_reference(ref_b.to_dict())):
        _assert_same_model(got, ref_b)
        want = ref_b.raw_score(xn, base, backend="host")
        np.testing.assert_array_equal(
            got.raw_score(xn, base, backend="host"), want)
        np.testing.assert_allclose(
            got.raw_score(xn, base, backend="device", device="cpu"),
            np.asarray(ref_b.raw_score(xn, base, backend="device")),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.scoring_plan(base)(xn[:64]),
                                   want[:64], rtol=1e-6, atol=1e-6)


def test_port_model_string_loads_in_reference():
    x, y = _data("regression", seed=6)
    b, base, _ = fit_booster(x, y, BoostParams(**dict(
        _COMMON, objective="regression", num_iterations=4)), device="cpu")
    ref_b = RefBooster.load_model_string(b.save_model_string())
    np.testing.assert_array_equal(ref_b.raw_score(x, base, backend="host"),
                                  b.raw_score(x, base, backend="host"))
    assert Booster.load_model_string(b.save_model_string()) \
        .save_model_string() == b.save_model_string()


def test_bin_mapper_from_reference():
    from mmlspark_tpu.ops import binning as ref_binning
    from mmlspark_tpu_torch.ops import binning as port_binning
    x, _ = _data("binary")
    m = ref_binning.fit_bins(x, max_bin=31)
    got = bin_mapper_from_reference(m.upper_bounds, m.n_bins, m.max_bin,
                                    m.categorical)
    np.testing.assert_array_equal(
        port_binning.apply_bins_device(got, x, device="cpu").numpy(),
        ref_binning.apply_bins(m, x))


def test_classifier_fit_transform_matches_reference():
    x, y = _data("binary", seed=7)
    # num_tasks=1: the single-device reference (the test session's 8
    # virtual CPU devices would otherwise send it to its mesh path)
    params = dict(num_iterations=5, max_depth=4, num_leaves=15, max_bin=63,
                  num_tasks=1)
    ref_m = RefClassifier(quality_profile=False, **params).fit(
        RefTable({"features": x, "label": y}))
    got_m = GBDTClassifier(device="cpu", **params).fit(
        Table({"features": torch.as_tensor(x), "label": y}))
    _assert_same_model(got_m.booster, ref_m.booster,
                       apply_bins(fit_bins(x, max_bin=63, seed=0), x))
    ref_t = ref_m.transform(RefTable({"features": x}))
    got_t = got_m.transform(Table({"features": x}))
    for col in ("raw_prediction", "probabilities"):
        np.testing.assert_allclose(got_t[col], ref_t[col], **_TOL)
    np.testing.assert_array_equal(got_t["prediction"], ref_t["prediction"])


def test_no_card_raises(monkeypatch):
    """Entry points resolve device=None to the card and never fall back
    to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _data("binary", n=200)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_booster(x, y, BoostParams(num_iterations=1))
    b, base, _ = fit_booster(x, y, BoostParams(num_iterations=1),
                             device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        b.raw_score(x, base, backend="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GBDTRegressor(num_iterations=1).fit(Table({"features": x,
                                                   "label": y}))


@pytest.mark.parametrize("param", [
    dict(out_of_core=True),
    dict(num_ingest_workers=2),
    dict(parallelism="voting_parallel", num_tasks=2),
    dict(features_shap_col="shap"),
    dict(quality_profile=True)])
def test_unported_estimator_params_raise(param):
    x, y = _data("binary", n=200)
    est = GBDTClassifier(num_iterations=1, device="cpu", **param)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        est.fit(Table({"features": x, "label": y}))


def test_voting_parallel_on_one_device_matches_reference():
    """voting_parallel on one device is the plain fit in both packages
    (num_tasks=1: the test session's 8 virtual CPU devices would
    otherwise shard the reference)."""
    x, y = _data("binary", seed=3)
    params = dict(num_iterations=5, max_depth=4, num_leaves=15, max_bin=63,
                  parallelism="voting_parallel", top_k=4, num_tasks=1)
    ref_m = RefClassifier(quality_profile=False, **params).fit(
        RefTable({"features": x, "label": y}))
    for tasks in (1, 0):  # num_tasks=0 on the CPU is one device
        got_m = GBDTClassifier(device="cpu", **dict(
            params, num_tasks=tasks)).fit(Table({"features": x, "label": y}))
        _assert_same_model(got_m.booster, ref_m.booster,
                           apply_bins(fit_bins(x, max_bin=63, seed=0), x))


def test_voting_parallel_over_many_cards_raises(monkeypatch):
    """Where the reference would shard (num_tasks=0 and more than one
    card), the port raises naming item 15."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    x, y = _data("binary", n=200)
    est = GBDTClassifier(num_iterations=1, device="cuda",
                         parallelism="voting_parallel")
    with pytest.raises(NotImplementedError, match="item 15"):
        est.fit(Table({"features": x, "label": y}))


def test_regressor_validation_column_matches_reference():
    """GBDTRegressor with a weight column, a validation-indicator column
    and early stopping: same model, same predictions as the reference."""
    from mmlspark_tpu.models.gbdt import GBDTRegressor as RefRegressor
    x, y = _data("regression", seed=8)
    rng = np.random.default_rng(11)
    cols = {"features": x, "label": y,
            "w": rng.uniform(0.5, 2.0, len(y)),
            "is_val": rng.random(len(y)) < 0.2}
    params = dict(num_iterations=6, max_depth=4, num_leaves=15, max_bin=63,
                  weight_col="w", validation_indicator_col="is_val",
                  early_stopping_round=2, num_tasks=1)
    ref_m = RefRegressor(quality_profile=False, **params).fit(
        RefTable(cols))
    got_m = GBDTRegressor(device="cpu", **params).fit(Table(cols))
    train = ~cols["is_val"]
    _assert_same_model(got_m.booster, ref_m.booster,
                       apply_bins(fit_bins(x[train], max_bin=63, seed=0),
                                  x[train]))
    np.testing.assert_allclose(
        got_m.transform(Table({"features": x}))["prediction"],
        ref_m.transform(RefTable({"features": x}))["prediction"], **_TOL)
