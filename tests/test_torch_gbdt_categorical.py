"""Port parity: native categorical splits (`mmlspark_tpu_torch.models.gbdt`)
against the JAX package, on the CPU.

Data has well-separated category effects (seeded permutations of evenly
spaced effects, as in tests/test_gbdt_categorical.py), so no two
categories' grad/(hess + cat_smooth) ratios come near a tie and f32
histogram sums in another order cannot reorder them. Checks:

- `raw_to_cat_bin` and `packed_member` equal the reference's bit for bit,
  and equal `ops.binning.apply_bins` of an identity-binned column;
- `_cat_gain_lattice` and `_best_splits_for_level` on the same histograms
  (values whose cumsums are exact in f32): gains within rtol 1e-6, the
  sort order, `is_cat`, features, bins and words equal;
- fits (binary, regression, multiclass, regression_l1 with leaf renewal,
  dart): equal split features, `split_is_cat` and words, every training
  row resting in the same leaf (numeric split bins may differ only where
  both send every row alike, ROADMAP Queue 3 (e)), leaf values and
  margins within rtol 1e-4, atol 1e-4, the tolerance of
  tests/test_torch_boosting.py;
- raw, binned, host and serving-plan scoring rest every row alike, for
  ids past the top bin, negatives, fractions and NaN, and for a bin count
  that is not a multiple of 16;
- boosters cross between the packages by `to_dict` and the model string.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.models.gbdt import GBDTClassifier as RefClassifier
from mmlspark_tpu.models.gbdt import trainer as ref_trainer
from mmlspark_tpu.models.gbdt.booster import Booster as RefBooster
from mmlspark_tpu.models.gbdt.booster import _cat_member_np as ref_member_np
from mmlspark_tpu.models.gbdt.boosting import BoostParams as RefParams
from mmlspark_tpu.models.gbdt.boosting import fit_booster as ref_fit
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.models.gbdt import (Booster, BoostParams,
                                            GBDTClassifier, fit_booster)
from mmlspark_tpu_torch.models.gbdt import trainer
from mmlspark_tpu_torch.models.gbdt.booster import _cat_member_np
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_reference
from mmlspark_tpu_torch.ops.binning import apply_bins, fit_bins

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_TOL = dict(rtol=1e-4, atol=1e-4)
_CAT = (3, 4)
_COMMON = dict(num_iterations=6, max_depth=4, num_leaves=15, max_bin=63,
               min_data_in_leaf=10, categorical_features=_CAT)


def _cat_data(objective="binary", n=2000, seed=0, levels=(24, 10)):
    """Three numeric columns and two categorical ones (columns 3, 4) whose
    effects are seeded permutations of evenly spaced values: no ordinal
    structure, no near-ties."""
    rng = np.random.default_rng(seed)
    x_num = rng.normal(size=(n, 3)).astype(np.float32)
    cats = [rng.integers(0, k, n) for k in levels]
    effs = [rng.permutation(np.linspace(-2, 2, k)) for k in levels]
    z = (sum(e[c] for e, c in zip(effs, cats)) + 0.5 * x_num[:, 0]
         - 0.3 * x_num[:, 1] + 0.3 * rng.normal(size=n))
    x = np.column_stack([x_num] + [c.astype(np.float32) for c in cats])
    if objective == "binary":
        y = (z > 0).astype(np.float32)
    elif objective == "multiclass":
        y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float32)
    else:
        y = z.astype(np.float32)
    return x.astype(np.float32), y


def _bins(x, max_bin=63, cat=_CAT):
    return apply_bins(fit_bins(x, max_bin=max_bin, seed=0,
                               categorical_features=cat), x)


def _leaves(b, bins, t):
    return trainer.leaf_of_binned(
        torch.as_tensor(bins), torch.as_tensor(b.split_feature[t]),
        torch.as_tensor(b.split_bin[t]), b.max_depth,
        torch.as_tensor(b.split_is_cat[t]),
        torch.as_tensor(b.cat_words[t])).numpy()


def _assert_same_cat_model(a, b, bins):
    np.testing.assert_array_equal(a.split_feature, b.split_feature)
    np.testing.assert_array_equal(a.split_is_cat, b.split_is_cat)
    np.testing.assert_array_equal(a.cat_words, b.cat_words)
    same = a.split_bin == b.split_bin
    assert same[a.split_is_cat].all()
    for t in range(a.n_trees):
        np.testing.assert_array_equal(_leaves(a, bins, t),
                                      _leaves(b, bins, t),
                                      err_msg=f"tree {t}")
    np.testing.assert_array_equal(a.threshold[same], b.threshold[same])
    np.testing.assert_array_equal(a.tree_class, b.tree_class)
    np.testing.assert_allclose(a.leaf_value, b.leaf_value, **_TOL)


def _probe_ids(seed, w16):
    """Ids with negatives, overflow past 16 * w16, fractions and NaN."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(-10, w16 * 16 + 40, 200).astype(np.float32),
        rng.normal(scale=100, size=40).astype(np.float32),
        np.array([np.nan, -0.4, 0.49, 0.5, 0.51, np.inf, -np.inf,
                  w16 * 16 - 0.5, w16 * 16 - 0.49], np.float32)])


@pytest.mark.parametrize("w16", [4, 16])
def test_membership_helpers_match_reference(w16):
    xf = _probe_ids(w16, w16)
    words = np.random.default_rng(1).integers(
        0, 1 << 16, size=(len(xf), w16)).astype(np.int32)
    got_b = trainer.raw_to_cat_bin(torch.as_tensor(xf), w16)
    want_b = np.asarray(ref_trainer.raw_to_cat_bin(jnp.asarray(xf), w16))
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    got = trainer.packed_member(got_b, torch.as_tensor(words))
    want = np.asarray(ref_trainer.packed_member(jnp.asarray(want_b),
                                                jnp.asarray(words)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_cat_member_np(xf, words),
                                  ref_member_np(xf, words))
    # the broadcast form the reference's level routing uses: (m, n) bins
    # against (m, 1, W16) words, and out-of-range word indices
    b2 = np.random.default_rng(2).integers(-40, w16 * 16 + 40, (3, 50))
    w2 = words[:3, None, :]
    np.testing.assert_array_equal(
        trainer.packed_member(torch.as_tensor(b2, dtype=torch.int32),
                              torch.as_tensor(w2)).numpy(),
        np.asarray(ref_trainer.packed_member(jnp.asarray(b2, jnp.int32),
                                             jnp.asarray(w2))))


@pytest.mark.parametrize("max_bin", [63, 255, 40])
def test_raw_to_cat_bin_follows_apply_bins(max_bin):
    """The serve-time bin of a raw id is the train-time bin of
    `apply_bins` on an identity-binned column; with B = max_bin + 1 not a
    multiple of 16, ids past the top and NaN land in a padding bin, which
    `_best_splits_for_level` gives the last bin's membership."""
    n_bins = max_bin + 1
    w16 = (n_bins + 15) // 16
    xf = _probe_ids(0, w16)
    binned = apply_bins(fit_bins(xf[:, None], max_bin=max_bin,
                                 categorical_features=(0,)),
                        xf[:, None])[:, 0]
    raw = trainer.raw_to_cat_bin(torch.as_tensor(xf), w16).numpy()
    np.testing.assert_array_equal(np.minimum(raw, n_bins - 1), binned)
    if n_bins % 16 == 0:
        np.testing.assert_array_equal(raw, binned)


def _histograms(m=4, f=6, b=64, seed=0, cat=(1, 4)):
    """Seeded level histograms with empty bins in the categorical
    features (counts 0, stats 0), as identity binning leaves them. Every
    value is a multiple of 1/4 below 2^20, so every cumsum is exact in f32
    whatever its order and both packages see the same sums."""
    rng = np.random.default_rng(seed)
    hc = rng.integers(0, 60, size=(m, f, b)).astype(np.float32)
    hc[:, list(cat)] *= rng.random((m, len(cat), b)) < 0.6
    hh = (hc * rng.integers(1, 4, size=hc.shape) / 4).astype(np.float32)
    hg = ((hc > 0) * np.round(rng.normal(scale=20, size=hc.shape))
          / 4).astype(np.float32)
    hg[:, list(cat)] *= 8      # strong category effects: some nodes win
    return hg, hh, hc


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_cat_threshold", [32, 3])
def test_split_search_matches_reference(seed, max_cat_threshold):
    cat = (1, 4)
    hg, hh, hc = _histograms(seed=seed, cat=cat)
    m, f, b = hg.shape
    fmask = np.ones(f, bool)
    fmask[2] = False
    kw = dict(n_features=f, n_bins=b, min_data_in_leaf=5,
              categorical_features=cat, max_cat_threshold=max_cat_threshold)
    ref_cfg = ref_trainer.TreeConfig(**kw)
    cfg = trainer.TreeConfig(**kw)
    parents = [a[:, 0].sum(-1) for a in (hg, hh, hc)]
    ref_args = [jnp.asarray(a) for a in (hg, hh, hc)] + [jnp.asarray(fmask),
                                                          ref_cfg]
    got_args = [torch.as_tensor(a) for a in (hg, hh, hc)] + [
        torch.as_tensor(fmask), cfg]
    ref_par = [jnp.asarray(p) for p in parents]
    got_par = [torch.as_tensor(p) for p in parents]

    rg, ro, rc = ref_trainer._cat_gain_lattice(*ref_args, *ref_par)
    gg, go, gc = trainer._cat_gain_lattice(*got_args, *got_par)
    np.testing.assert_array_equal(go.numpy(), np.asarray(ro))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    rg, gg = np.asarray(rg), gg.numpy()
    np.testing.assert_array_equal(np.isfinite(gg), np.isfinite(rg))
    np.testing.assert_allclose(gg[np.isfinite(gg)], rg[np.isfinite(rg)],
                               rtol=1e-6)

    want = [np.asarray(v) for v in ref_trainer._best_splits_for_level(
        *ref_args, *ref_par)]
    got = [v.numpy() for v in trainer._best_splits_for_level(
        *got_args, *got_par)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    for g, w, name in zip(got[1:], want[1:], ("feature", "bin", "is_cat",
                                              "words")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[3].any()


@pytest.mark.parametrize("case", ["binary", "regression", "multiclass",
                                  "regression_l1", "dart"])
def test_fit_booster_matches_reference(case):
    objective = {"dart": "binary"}.get(case, case)
    x, y = _cat_data(objective, seed=3)
    kw = dict(_COMMON, objective=objective)
    if case == "multiclass":
        kw.update(num_class=3, num_iterations=3)
    if case == "dart":
        # skip_drop=1 draws no drop set (the packages' draws differ)
        kw.update(boosting="dart", skip_drop=1.0)
    ref_b, ref_base, _ = ref_fit(x, y, RefParams(**kw))
    got_b, got_base, _ = fit_booster(x, y, BoostParams(**kw), device="cpu")
    assert got_base == ref_base
    assert got_b.split_is_cat.any()
    _assert_same_cat_model(got_b, ref_b, _bins(x))
    np.testing.assert_allclose(
        got_b.raw_score(x, got_base, backend="device", device="cpu"),
        ref_b.raw_score(x, ref_base), **_TOL)


def test_validation_and_renewal_take_categorical_routes():
    """Validation margins (binned descent) and leaf renewal (resting
    leaves) route categorical nodes by their words: the early-stopping
    history equals the reference's."""
    x, y = _cat_data("regression", seed=4)
    vx, vy = _cat_data("regression", n=500, seed=5)
    kw = dict(_COMMON, objective="huber", alpha=1.0, early_stopping_round=2,
              metric="l2")
    ref_b, ref_base, ref_hist = ref_fit(x, y, RefParams(**kw),
                                        valid=(vx, vy))
    got_b, got_base, got_hist = fit_booster(x, y, BoostParams(**kw),
                                            valid=(vx, vy), device="cpu")
    _assert_same_cat_model(got_b, ref_b, _bins(x))
    np.testing.assert_allclose(got_hist, ref_hist, rtol=1e-4)
    assert got_b.best_iteration == ref_b.best_iteration


@pytest.mark.parametrize("max_bin", [63, 40])
def test_all_scoring_paths_rest_rows_alike(max_bin):
    x, y = _cat_data(seed=6, levels=(24, 10))
    # ids past the top bin in training too, so the last bin is populated
    x[:60, 3] = 200.0
    x[60:90, 4] = np.nan
    kw = dict(_COMMON, objective="binary", max_bin=max_bin)
    b, base, _ = fit_booster(x, y, BoostParams(**kw), device="cpu")
    assert b.split_is_cat.any()
    probe = np.repeat(x[:1], 12, axis=0)
    probe[:, 3] = [999.0, 77.0, np.nan, -5.0, 63.0, 5.0, 5.4, 4.6, 40.0,
                   39.6, -0.2, np.inf]
    probe[:, 4] = probe[::-1, 3]
    probe[:2, 4] = 3.0
    rows = np.concatenate([x, probe])
    bins = apply_bins(fit_bins(x, max_bin=max_bin, seed=0,
                               categorical_features=_CAT), rows)
    binned = sum(
        trainer.predict_binned(
            torch.as_tensor(bins), torch.as_tensor(b.split_feature[t]),
            torch.as_tensor(b.split_bin[t]),
            torch.as_tensor(b.leaf_value[t]), b.max_depth,
            torch.as_tensor(b.split_is_cat[t]),
            torch.as_tensor(b.cat_words[t])).numpy()
        for t in range(b.n_trees)) + base
    host = b.raw_score(rows, base, backend="host")[:, 0]
    device = b.raw_score(rows, base, backend="device", device="cpu")[:, 0]
    served = b.scoring_plan(base)(rows)[:, 0]
    np.testing.assert_array_equal(host, device)
    np.testing.assert_allclose(binned, host, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(served, host, rtol=1e-5, atol=1e-5)
    # unseen ids 999 and 77 both share the top bin: the same leaves
    assert host[len(x)] == host[len(x) + 1]


def test_max_cat_threshold_caps_set_size():
    """Depth-1 trees: the root's reachable categories are every category
    present, so the cap is checked exactly."""
    x, y = _cat_data(n=2000, seed=7, levels=(40, 10))
    kw = dict(_COMMON, objective="binary", max_depth=1, max_cat_threshold=3)
    b, _, _ = fit_booster(x, y, BoostParams(**kw), device="cpu")
    ref_b, _, _ = ref_fit(x, y, RefParams(**kw))
    np.testing.assert_array_equal(b.cat_words, ref_b.cat_words)
    assert b.split_is_cat.any()
    for t, nd in zip(*np.nonzero(b.split_is_cat)):
        f = b.split_feature[t, nd]
        present = np.unique(x[:, f].astype(int))
        words = b.cat_words[t, nd]
        k = sum(int((words[c >> 4] >> (c & 15)) & 1) for c in present)
        assert k <= 3 or len(present) - k <= 3, (t, nd, k)


def test_categorical_beats_ordinal():
    x, y = _cat_data(seed=8)
    kw = dict(objective="binary", num_iterations=8, max_depth=3, max_bin=63,
              min_data_in_leaf=5)
    bc, base_c, _ = fit_booster(x, y, BoostParams(categorical_features=_CAT,
                                                  **kw), device="cpu")
    bo, base_o, _ = fit_booster(x, y, BoostParams(**kw), device="cpu")
    assert bo.split_is_cat is None

    def auc(m):
        r = np.empty(len(m))
        r[np.argsort(m)] = np.arange(1, len(m) + 1)
        npos = y.sum()
        return (r[y == 1].sum() - npos * (npos + 1) / 2) / (
            npos * (len(y) - npos))
    assert auc(bc.raw_score(x, base_c)[:, 0]) > \
        auc(bo.raw_score(x, base_o)[:, 0]) + 0.02


_EST = dict(num_iterations=4, max_depth=3, max_bin=63, min_data_in_leaf=10,
            num_tasks=1)


def test_slot_names_resolve_through_feature_names():
    x, y = _cat_data(seed=9)
    names = ["n0", "n1", "n2", "color", "shape"]
    t = Table({"features": x, "label": y}).with_column_meta(
        "features", feature_names=names)
    by_name = GBDTClassifier(device="cpu", categorical_slot_names=(
        "color", "shape"), **_EST).fit(t)
    by_index = GBDTClassifier(device="cpu", categorical_slot_indexes=_CAT,
                              **_EST).fit(t)
    mixed = GBDTClassifier(device="cpu", categorical_slot_indexes=(3,),
                           categorical_slot_names=("shape",), **_EST).fit(t)
    ref = RefClassifier(quality_profile=False, categorical_slot_names=(
        "color", "shape"), **_EST).fit(RefTable(
            {"features": x, "label": y}).with_column_meta(
            "features", feature_names=names))
    assert by_name.booster.split_is_cat.any()
    for other in (by_index, mixed):
        np.testing.assert_array_equal(other.booster.cat_words,
                                      by_name.booster.cat_words)
    _assert_same_cat_model(by_name.booster, ref.booster, _bins(x))
    np.testing.assert_allclose(
        by_name.transform(t)["probabilities"],
        ref.transform(RefTable({"features": x}))["probabilities"], **_TOL)
    with pytest.raises(KeyError, match="missing"):
        GBDTClassifier(device="cpu", categorical_slot_names=("missing",),
                       **_EST).fit(t)
    with pytest.raises(ValueError, match="feature_names"):
        GBDTClassifier(device="cpu", categorical_slot_names=("color",),
                       **_EST).fit(Table({"features": x, "label": y}))


def test_boosters_cross_between_packages():
    x, y = _cat_data(seed=10)
    kw = dict(_COMMON, objective="binary")
    ref_b, ref_base, _ = ref_fit(x, y, RefParams(**kw))
    assert ref_b.split_is_cat.any()
    want = ref_b.raw_score(x, ref_base, backend="host")
    for got in (booster_from_reference(ref_b.to_dict()),
                Booster.load_model_string(ref_b.save_model_string())):
        np.testing.assert_array_equal(got.split_is_cat, ref_b.split_is_cat)
        np.testing.assert_array_equal(got.cat_words, ref_b.cat_words)
        np.testing.assert_array_equal(
            got.raw_score(x, ref_base, backend="host"), want)
        np.testing.assert_allclose(
            got.raw_score(x, ref_base, backend="device", device="cpu"),
            want, rtol=1e-6, atol=1e-6)
    port_b, port_base, _ = fit_booster(x, y, BoostParams(**kw),
                                       device="cpu")
    back = RefBooster.load_model_string(port_b.save_model_string())
    np.testing.assert_array_equal(
        back.raw_score(x, port_base, backend="host"),
        port_b.raw_score(x, port_base, backend="host"))
    again = Booster.from_dict(port_b.to_dict())
    np.testing.assert_array_equal(again.cat_words, port_b.cat_words)
