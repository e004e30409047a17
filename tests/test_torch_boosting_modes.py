"""Port parity: stochastic boosting (bagging, feature_fraction, goss, rf,
dart), the L1-family leaf renewal, `fobj`, lambdarank and `GBDTRanker`
(`mmlspark_tpu_torch.models.gbdt`) against the JAX package, on the CPU.

The port draws from a `torch.Generator`, the reference from threefry keys
(ROADMAP Queue 3 (b)), so no draw can match. Three kinds of check:

- modes that draw nothing (goss with other_rate=0, dart with skip_drop=1,
  renewal, fobj, lambdarank) are compared directly;
- modes that draw get the same seeded numpy masks in both packages, by
  monkeypatching each package's `_row_weights` / `_feature_mask` (and
  dart's drop draws); `jax.clear_caches()` first, so that the reference's
  jitted chunk is traced with the patched function;
- the port's own draws are checked statistically: bagged share, the exact
  feature count, the bagging_freq phase, GOSS shares and dart drop counts.

Fit comparisons use `test_torch_boosting._assert_same_model`: equal split
features, split bins equal up to empty-bin ties (Queue 3 (e)), leaf values
and scores within rtol 1e-4, atol 1e-4 (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_boosting import _assert_same_model, _data

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.models.gbdt import boosting as ref_boosting
from mmlspark_tpu.models.gbdt import objectives as ref_obj
from mmlspark_tpu.models.gbdt.boosting import BoostParams as RefParams
from mmlspark_tpu.models.gbdt.boosting import fit_booster as ref_fit
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.models.gbdt import (BoostParams, GBDTRanker,
                                            fit_booster)
from mmlspark_tpu_torch.models.gbdt import boosting as port_boosting
from mmlspark_tpu_torch.models.gbdt import objectives as port_obj
from mmlspark_tpu_torch.ops.binning import apply_bins, fit_bins

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_TOL = dict(rtol=1e-4, atol=1e-4)
_COMMON = dict(num_iterations=6, max_depth=4, num_leaves=15, max_bin=63,
               min_data_in_leaf=20)


def _compare(x, y, kw, ref_kw=None, port_kw=None):
    """Fit both packages with the same params; same model, same scores."""
    ref_b, ref_base, ref_hist = ref_fit(x, y, RefParams(**kw),
                                        **(ref_kw or {}))
    got_b, got_base, got_hist = fit_booster(x, y, BoostParams(**kw),
                                            device="cpu", **(port_kw or {}))
    assert got_base == ref_base
    assert got_b.n_trees == ref_b.n_trees > 0
    _assert_same_model(got_b, ref_b,
                       apply_bins(fit_bins(x, max_bin=kw["max_bin"], seed=0),
                                  x))
    np.testing.assert_allclose(
        got_b.raw_score(x, got_base, backend="host"),
        ref_b.raw_score(x, ref_base), **_TOL)
    np.testing.assert_allclose(got_hist, ref_hist, rtol=1e-4)


@pytest.mark.parametrize("mode", [
    # regression: binary's first gradients take two values, so GOSS would
    # keep one class alone and every split would gain 0 up to rounding
    dict(objective="regression", boosting="goss", top_rate=0.3,
         other_rate=0.0),
    dict(objective="binary", boosting="dart", skip_drop=1.0),
    dict(objective="binary", boosting="dart", skip_drop=1.0,
         xgboost_dart_mode=True)])
def test_draw_free_modes_match_reference(mode):
    x, y = _data(mode["objective"], seed=21)
    _compare(x, y, dict(_COMMON, **mode))


def _inject_masks(monkeypatch, n, n_features, iters, frac, ff, seed=0):
    """Give both packages the same seeded per-iteration row masks (frac
    < 1) and one feature mask (ff < 1)."""
    rng = np.random.default_rng(seed)
    rows = (rng.random((iters, n)) < frac).astype(np.float32)
    feats = np.zeros(n_features, bool)
    feats[rng.permutation(n_features)[:max(1, round(ff * n_features))]] = True
    if frac < 1:
        monkeypatch.setattr(ref_boosting, "_row_weights",
                            lambda p, g, key, it, mc: jnp.asarray(rows)[it])
        monkeypatch.setattr(port_boosting, "_row_weights",
                            lambda p, g, gen, it, mc: torch.as_tensor(
                                rows[it]))
    if ff < 1:
        monkeypatch.setattr(ref_boosting, "_feature_mask",
                            lambda p, key, nf: jnp.asarray(feats))
        monkeypatch.setattr(port_boosting, "_feature_mask",
                            lambda p, gen, nf: torch.as_tensor(feats))
    jax.clear_caches()


@pytest.mark.parametrize("case", ["bagging", "feature_fraction",
                                  "rf_bagging", "multiclass_bagging_ff",
                                  "goss_weighted"])
def test_injected_masks_match_reference(monkeypatch, case):
    objective = "multiclass" if case.startswith("multiclass") else "binary"
    x, y = _data(objective, seed=22)
    kw = dict(_COMMON, objective=objective)
    frac, ff = 0.7, 1.0
    if case == "bagging":
        kw.update(bagging_fraction=0.7, bagging_freq=1)
    elif case == "feature_fraction":
        kw.update(feature_fraction=0.6)
        frac, ff = 1.0, 0.6
    elif case == "rf_bagging":
        kw.update(boosting="rf", bagging_fraction=0.7, bagging_freq=1)
    elif case == "multiclass_bagging_ff":
        # a node pure in one class has equal gradients on every row, so
        # each of its splits gains ~1e-6 of f32 noise; a positive
        # min_gain_to_split keeps both packages from splitting on noise
        kw.update(num_class=3, num_iterations=3, bagging_fraction=0.7,
                  bagging_freq=1, feature_fraction=0.6,
                  min_gain_to_split=1e-3)
        ff = 0.6
    else:
        # GOSS-shaped injected weights: amplified survivors (w = 4)
        kw.update(boosting="goss")
        frac = 1.0
    _inject_masks(monkeypatch, len(y), x.shape[1], kw["num_iterations"],
                  frac, ff)
    if case == "goss_weighted":
        amp = np.random.default_rng(1).random((kw["num_iterations"],
                                               len(y))) < 0.3
        w = np.where(amp, 4.0, np.random.default_rng(2).random(
            (kw["num_iterations"], len(y))) < 0.5).astype(np.float32)
        monkeypatch.setattr(ref_boosting, "_row_weights",
                            lambda p, g, key, it, mc: jnp.asarray(w)[it])
        monkeypatch.setattr(port_boosting, "_row_weights",
                            lambda p, g, gen, it, mc: torch.as_tensor(w[it]))
    _compare(x, y, kw)


def _inject_dart_drops(monkeypatch, iters, seed=0):
    """The same dart drop draws in both packages: the reference reads
    jax.random.uniform (one scalar per iteration, then one (n_prev,)
    vector when it drops); the port's `_dart_drops` gets the same
    numbers."""
    rng = np.random.default_rng(seed)
    skip = rng.random(iters)
    vec = {k: rng.random(k).astype(np.float32) for k in range(1, iters)}
    calls = []

    def fake_uniform(key, shape=(), *a, **k):
        if shape == ():
            calls.append(1)
            return jnp.float32(skip[len(calls)])
        return jnp.asarray(vec[shape[0]])

    def port_drops(p, gen, n_prev):
        if n_prev == 0 or skip[n_prev] < p.skip_drop:
            return []
        drop_p = min(p.drop_rate, p.max_drop / max(n_prev, 1))
        return np.nonzero(vec[n_prev] < drop_p)[0].tolist()
    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    monkeypatch.setattr(port_boosting, "_dart_drops", port_drops)
    return skip, vec


@pytest.mark.parametrize("xgb", [False, True])
def test_dart_with_injected_drops_matches_reference(monkeypatch, xgb):
    """dart with drops at several iterations: the dropped margins, the
    LightGBM (or xgboost) weight normalization, the validation deltas and
    the weights folded into the Booster's leaves."""
    x, y = _data("regression", seed=23)
    vx, vy = _data("regression", n=400, seed=24)
    kw = dict(_COMMON, objective="regression", boosting="dart",
              num_iterations=8, drop_rate=0.5, skip_drop=0.3,
              xgboost_dart_mode=xgb, metric="l2")
    skip, _ = _inject_dart_drops(monkeypatch, kw["num_iterations"])
    assert (skip[1:] >= 0.3).sum() >= 3          # several iterations drop
    _compare(x, y, kw, ref_kw=dict(valid=(vx, vy)),
             port_kw=dict(valid=(vx, vy)))


@pytest.mark.parametrize("objective,extra", [
    ("regression_l1", {}), ("quantile", dict(alpha=0.7)),
    ("huber", dict(alpha=0.9)), ("quantile_weighted", dict(alpha=0.3))])
def test_renewal_objectives_match_reference(objective, extra):
    x, y = _data("regression", seed=25)
    y = (3.0 * y + np.random.default_rng(5).standard_t(2, len(y))) \
        .astype(np.float32)
    fit_kw = {}
    if objective == "quantile_weighted":
        objective = "quantile"
        w = np.random.default_rng(6).uniform(0.5, 2.0, len(y))
        w[::5] = 0.0                              # leaves renew without them
        fit_kw = dict(weights=w.astype(np.float32))
    _compare(x, y, dict(_COMMON, objective=objective, **extra),
             ref_kw=fit_kw, port_kw=fit_kw)


def test_fobj_matches_reference():
    """A custom objective, called by each package on its own arrays."""
    x, y = _data("binary", seed=26)

    def logistic(m, t):
        pr = 1 / (1 + (-m).exp()) if isinstance(m, torch.Tensor) \
            else jax.nn.sigmoid(m)
        return pr - t, pr * (1 - pr)
    _compare(x, y, dict(_COMMON, objective="binary", fobj=logistic,
                        num_iterations=4))


def _ranking_data(n_groups=60, seed=27):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(5, 30, n_groups)
    group = np.repeat(rng.permutation(n_groups) * 7 + 3, sizes)
    x = rng.normal(size=(len(group), 8)).astype(np.float32)
    rel = x[:, :3] @ np.array([1.0, -0.5, 0.3]) + 0.5 * rng.normal(
        size=len(group))
    y = np.digitize(rel, np.quantile(rel, [0.5, 0.75, 0.9, 0.97]))
    return x, y.astype(np.float32), group


def test_group_index_and_lambdarank_grad_match_reference():
    _, y, group = _ranking_data()
    want_idx = ref_obj.make_group_index(group)
    got_idx = port_obj.make_group_index(group)
    np.testing.assert_array_equal(got_idx, want_idx)
    scores = np.random.default_rng(3).normal(size=len(y)).astype(np.float32)
    scores[::4] = 0.25                             # ties rank in data order
    for max_position, sigmoid in ((0, 1.0), (5, 2.0)):
        want = ref_obj.lambdarank_grad_hess(
            jnp.asarray(scores), jnp.asarray(y), jnp.asarray(want_idx),
            sigmoid=sigmoid, max_position=max_position)
        got = port_obj.lambdarank_grad_hess(
            torch.as_tensor(scores), torch.as_tensor(y),
            torch.as_tensor(got_idx), sigmoid=sigmoid,
            max_position=max_position)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6)


def test_lambdarank_fit_matches_reference():
    x, y, group = _ranking_data()
    _compare(x, y, dict(_COMMON, objective="lambdarank", max_position=10,
                        min_data_in_leaf=10),
             ref_kw=dict(group=group), port_kw=dict(group=group))


def test_ranker_fit_transform_matches_reference():
    from mmlspark_tpu.models.gbdt import GBDTRanker as RefRanker
    x, y, group = _ranking_data(seed=28)
    cols = {"features": x, "label": y, "group": group}
    params = dict(num_iterations=4, max_depth=4, num_leaves=15, max_bin=63,
                  min_data_in_leaf=10, max_position=8, num_tasks=1)
    ref_m = RefRanker(quality_profile=False, **params).fit(RefTable(cols))
    got_m = GBDTRanker(device="cpu", **params).fit(Table(cols))
    _assert_same_model(got_m.booster, ref_m.booster,
                       apply_bins(fit_bins(x, max_bin=63, seed=0), x))
    np.testing.assert_allclose(
        got_m.transform(Table({"features": x}))["prediction"],
        ref_m.transform(RefTable({"features": x}))["prediction"], **_TOL)
    with pytest.raises(ValueError, match="group"):
        fit_booster(x, y, BoostParams(objective="lambdarank",
                                      num_iterations=1), device="cpu")


# ------------------------------------------------ the port's own draws

def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_bagging_share_and_phase():
    n = 20_000
    grad = torch.randn(n, generator=_gen(1))
    p = BoostParams(bagging_fraction=0.7, bagging_freq=3)
    shares = {}
    for it in range(7):
        w = port_boosting._row_weights(p, grad, _gen(it), it, False)
        if it % 3:
            assert w is None, it                 # off-phase: every row
        else:
            assert set(w.unique().tolist()) <= {0.0, 1.0}
            shares[it] = float(w.mean())
    assert sorted(shares) == [0, 3, 6]
    for s in shares.values():                    # sd 0.0032: 6 sigma
        assert abs(s - 0.7) < 0.02
    rf = BoostParams(boosting="rf", bagging_fraction=0.5)   # freq ignored
    assert port_boosting._row_weights(rf, grad, _gen(), 1, False) is not None
    assert port_boosting._row_weights(BoostParams(), grad, _gen(), 0,
                                      False) is None


def test_feature_fraction_takes_exactly_kf():
    for ff, nf, kf in ((0.55, 9, 5), (0.8, 32, 26), (0.01, 10, 1),
                       (0.5, 5, 2)):            # round half to even, as
        p = BoostParams(feature_fraction=ff)    # the reference's round()
        masks = {tuple(port_boosting._feature_mask(p, _gen(s), nf).tolist())
                 for s in range(20)}
        assert all(sum(m) == kf for m in masks), (ff, nf)
        assert len(masks) > 1 or kf == nf
    assert bool(port_boosting._feature_mask(BoostParams(), _gen(), 4).all())


def test_goss_keeps_top_and_amplifies_a_sample():
    n = 50_000
    grad = torch.randn(n, generator=_gen(2))
    p = BoostParams(boosting="goss", top_rate=0.2, other_rate=0.1)
    w = port_boosting._row_weights(p, grad, _gen(3), 0, False)
    top = w == 1.0
    assert int(top.sum()) == int(0.2 * n)
    assert float(grad.abs()[top].min()) >= float(grad.abs()[~top].max())
    amp = w[(w != 0) & ~top]
    assert torch.allclose(amp, torch.full_like(amp, 0.8 / 0.1))
    # the rest keep other_rate / (1 - top_rate) of their rows (sd 0.0015)
    assert abs(amp.numel() / (n - int(top.sum())) - 0.125) < 0.01


def test_dart_drop_counts():
    """E[dropped] = (1 - skip_drop) * n_prev * min(drop_rate,
    max_drop / n_prev) over 2000 draws (sd of the mean ~0.03)."""
    for n_prev, max_drop, want in ((20, 50, 0.5 * 20 * 0.1),
                                   (100, 5, 0.5 * 100 * 0.05)):
        p = BoostParams(boosting="dart", drop_rate=0.1, skip_drop=0.5,
                        max_drop=max_drop)
        counts = [len(port_boosting._dart_drops(p, _gen(s), n_prev))
                  for s in range(2000)]
        assert abs(np.mean(counts) - want) < 0.15, (n_prev, np.mean(counts))
        assert all(max(d, default=0) < n_prev for d in
                   (port_boosting._dart_drops(p, _gen(s), n_prev)
                    for s in range(50)))
    never = BoostParams(boosting="dart", skip_drop=1.0)
    assert all(port_boosting._dart_drops(never, _gen(s), 10) == []
               for s in range(50))


def test_stochastic_fit_is_reproducible_from_its_seed():
    x, y = _data("binary", n=1500, seed=29)
    kw = dict(_COMMON, objective="binary", boosting="goss",
              feature_fraction=0.7, num_iterations=4)
    a = fit_booster(x, y, BoostParams(**kw), device="cpu")[0]
    b = fit_booster(x, y, BoostParams(**kw), device="cpu")[0]
    c = fit_booster(x, y, BoostParams(seed=1, **kw), device="cpu")[0]
    np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    assert not np.array_equal(a.split_feature, c.split_feature) or \
        not np.array_equal(a.leaf_value, c.leaf_value)


def test_leaf_quantiles_match_numpy():
    rng = np.random.default_rng(30)
    resid = rng.normal(size=5000).astype(np.float32)
    nodes = rng.integers(0, 7, 5000)
    keep = rng.random(5000) < 0.8
    for q in (0.0, 0.3, 0.5, 0.95, 1.0):
        val, has = port_boosting._leaf_quantiles(
            torch.as_tensor(nodes), torch.as_tensor(resid),
            torch.as_tensor(keep), q, 9)
        assert has.tolist() == [True] * 7 + [False] * 2
        want = [np.quantile(resid[(nodes == k) & keep], q) for k in range(7)]
        np.testing.assert_allclose(val[:7].numpy(), want, rtol=1e-6,
                                   atol=1e-6)


def test_ranker_validation_column_takes_training_groups():
    """With a validation column the ranker trains on the training rows'
    group ids (the reference passes the whole table's, ROADMAP Queue 3
    (n)); a group of another length is refused."""
    x, y, group = _ranking_data(seed=31)
    is_val = np.isin(group, np.unique(group)[::4])
    cols = {"features": x, "label": y, "group": group, "v": is_val}
    params = dict(num_iterations=2, max_depth=3, num_leaves=7, max_bin=63,
                  min_data_in_leaf=10)
    got = GBDTRanker(device="cpu", validation_indicator_col="v",
                     **params).fit(Table(cols)).booster
    want = fit_booster(x[~is_val], y[~is_val], BoostParams(
        objective="lambdarank", max_position=30, **params),
        group=np.unique(group, return_inverse=True)[1][~is_val],
        device="cpu")[0]
    np.testing.assert_array_equal(got.leaf_value, want.leaf_value)
    with pytest.raises(ValueError, match="ids for"):
        fit_booster(x[~is_val], y[~is_val], BoostParams(
            objective="lambdarank", num_iterations=1), group=group,
            device="cpu")
