"""Port parity: data-parallel and voting-parallel GBDT over the port's
mesh (`fit_booster_distributed`, `trainer.train_one_tree_sharded`), and
the mesh's row helpers, against the JAX package on the CPU.

The port's mesh here is four CPU positions (`devices=["cpu"] * 4`), the
reference's four of the virtual CPU devices of tests/conftest.py
(`num_tasks=4`). Without bagging both sum the same per-position histograms (in another order), so
the model must be the same in ROADMAP Queue 3 (e)'s sense: equal split
features, every training row resting in the same leaf, leaf values and
margins within rtol 1e-4, atol 1e-4 (`test_torch_boosting.
_assert_same_model`); the same for voting_parallel with a small top_k,
1,003 ragged rows and categorical data. Draws differ between the
packages (Queue 3 (b)): goss and dart are compared by their train
metrics, and the port's per-position draws are checked for what they
must be. A one-position mesh is the plain fit bit for bit.
"""
import numpy as np
import pytest
import torch

from test_torch_boosting import _assert_same_model, _data

from mmlspark_tpu import parallel as ref_parallel
from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.models.gbdt import GBDTClassifier as RefClassifier
from mmlspark_tpu.models.gbdt.boosting import BoostParams as RefParams
from mmlspark_tpu.models.gbdt.distributed import (
    fit_booster_distributed as ref_fit_dist)
from mmlspark_tpu_torch import parallel
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.models.gbdt import (BoostParams, GBDTClassifier,
                                            fit_booster,
                                            fit_booster_distributed,
                                            make_sharded_tree_fn)
from mmlspark_tpu_torch.models.gbdt import boosting as port_boosting
from mmlspark_tpu_torch.models.gbdt import trainer
from mmlspark_tpu_torch.ops.binning import apply_bins, fit_bins

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_TOL = dict(rtol=1e-4, atol=1e-4)
_COMMON = dict(num_iterations=5, max_depth=4, num_leaves=15, max_bin=63,
               min_data_in_leaf=20)
_CAT = (3, 4)


def _mesh(n=4):
    return parallel.data_mesh(devices=["cpu"] * n)


def _cat_data(n=1003, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    ids = [rng.integers(0, k, n) for k in (16, 9)]
    effs = [rng.permutation(np.linspace(-2, 2, k)) for k in (16, 9)]
    z = sum(e[c] for e, c in zip(effs, ids)) + 0.5 * x[:, 0]
    x[:, 3], x[:, 4] = ids[0], ids[1]
    return x, (z + 0.3 * rng.normal(size=n) > 0).astype(np.float32)


def _margins(booster, base, x):
    return booster.raw_score(x, base, backend="host")[:, 0]


def _auc(score, y):
    order = np.argsort(score, kind="stable")
    ranks = np.empty(len(score))
    ranks[order] = np.arange(1, len(score) + 1)
    npos = y.sum()
    return (ranks[y == 1].sum() - npos * (npos + 1) / 2) / (
        npos * (len(y) - npos))


@pytest.mark.parametrize("case", ["data_parallel", "voting_ragged",
                                  "voting_categorical", "weighted_ragged"])
def test_distributed_fit_matches_reference(case):
    kw = dict(_COMMON)
    fit_kw = dict(parallelism="data_parallel")
    cat = ()
    if case == "data_parallel":
        x, y = _data("binary", n=2000, seed=1)
    elif case == "voting_ragged":
        x, y = _data("binary", n=1003, f=10, seed=2)
        fit_kw = dict(parallelism="voting_parallel", top_k=2)
    elif case == "voting_categorical":
        x, y = _cat_data()
        cat = _CAT
        kw.update(categorical_features=cat, min_data_in_leaf=10)
        fit_kw = dict(parallelism="voting_parallel", top_k=2)
    else:
        x, y = _data("regression", n=1003, seed=3)
        kw.update(objective="regression")
        fit_kw["weights"] = np.random.default_rng(4).uniform(
            0.5, 2.0, x.shape[0]).astype(np.float32)
    ref_b, ref_base, _ = ref_fit_dist(x, y, RefParams(**kw), num_tasks=4,
                                      **fit_kw)
    got_b, got_base, _ = fit_booster_distributed(x, y, BoostParams(**kw),
                                                 mesh=_mesh(), **fit_kw)
    np.testing.assert_allclose(got_base, ref_base, rtol=1e-12)
    if cat:
        assert got_b.split_is_cat is not None and got_b.split_is_cat.any()
        np.testing.assert_array_equal(got_b.split_is_cat,
                                      ref_b.split_is_cat)
        np.testing.assert_array_equal(got_b.cat_words, ref_b.cat_words)
    bins = apply_bins(fit_bins(x, max_bin=63, seed=0,
                               categorical_features=cat), x)
    _assert_same_model(got_b, ref_b, bins)
    np.testing.assert_allclose(_margins(got_b, got_base, x),
                               _margins(ref_b, ref_base, x), **_TOL)


def test_one_position_mesh_is_the_plain_fit_bit_for_bit():
    x, y = _data("binary", n=1500, seed=5)
    for extra in (dict(), dict(bagging_fraction=0.7, bagging_freq=1,
                               feature_fraction=0.6),
                  dict(boosting="goss")):
        p = BoostParams(**_COMMON, **extra)
        want, want_base, _ = fit_booster(x, y, p, device="cpu")
        got, got_base, _ = fit_booster_distributed(x, y, p, mesh=_mesh(1))
        assert got_base == want_base
        for f in ("split_feature", "split_bin", "leaf_value", "gain",
                  "cover", "threshold"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f"{extra} {f}")


def test_padding_never_counts_toward_min_data_in_leaf():
    """A ragged fit's padding rows have weight 0 and presence 0: the node
    covers count the real rows only, while a user's zero weights still
    count (LightGBM)."""
    x, y = _data("binary", n=1003, seed=6)
    w = np.ones(1003, np.float32)
    w[:100] = 0.0
    p = BoostParams(**dict(_COMMON, num_iterations=2))
    booster, _, _ = fit_booster_distributed(x, y, p, weights=w,
                                            mesh=_mesh())
    assert booster.cover[0, 0] == 1003
    assert booster.cover[:, 1:3].sum(1).tolist() == [1003.0] * 2
    # the same through the estimator, whose num_tasks picks the mesh
    est = GBDTClassifier(num_tasks=4, device="cpu", **_COMMON).fit(
        Table({"features": x, "label": y}))
    ref = RefClassifier(num_tasks=4, quality_profile=False, **_COMMON).fit(
        RefTable({"features": x, "label": y}))
    _assert_same_model(est.booster, ref.booster,
                       apply_bins(fit_bins(x, max_bin=63, seed=0), x))


def test_presence_channel_and_position_draws():
    """`_presence` drops padding and bagged-out rows; position 0 draws with
    the iteration's seed, the others with seeds of their own."""
    pres = torch.tensor([1.0, 1.0, 0.0, 1.0])
    row_w = torch.tensor([1.0, 0.0, 1.0, 2.0])
    assert port_boosting._presence(None, None) is None
    np.testing.assert_array_equal(
        port_boosting._presence(pres, row_w).numpy(), [1, 0, 0, 1])
    np.testing.assert_array_equal(
        port_boosting._presence(pres, None).numpy(), [1, 1, 0, 1])
    seeds = {port_boosting._position_seed(7, 3, q) for q in range(4)}
    assert len(seeds) == 4
    assert port_boosting._position_seed(7, 3, 0) == \
        port_boosting._iteration_seed(7, 3)


def test_bagging_draws_differ_per_position(monkeypatch):
    """Each position draws its own bagging mask over its own rows."""
    seen = []
    real = port_boosting._row_weights

    def spy(p, grad, gen, it, multiclass):
        out = real(p, grad, gen, it, multiclass)
        seen.append(out.clone())
        return out
    monkeypatch.setattr(port_boosting, "_row_weights", spy)
    x, y = _data("binary", n=2000, seed=7)
    p = BoostParams(**dict(_COMMON, num_iterations=1, bagging_fraction=0.5,
                           bagging_freq=1))
    fit_booster_distributed(x, y, p, mesh=_mesh())
    assert len(seen) == 4 and all(s.shape == (500,) for s in seen)
    assert all(abs(float(s.mean()) - 0.5) < 0.1 for s in seen)
    assert len({tuple(s.tolist()) for s in seen}) == 4


@pytest.mark.parametrize("boosting", ["goss", "dart"])
def test_stochastic_modes_match_reference_statistically(boosting):
    """goss and dart draw from other streams in each package (and a fit's
    metric moves with its seed by ~0.05 here): over seeds 0-3 on 4
    positions, the mean train logloss and AUC must agree closely."""
    x, y = _data("binary", n=3000, seed=8)
    kw = dict(_COMMON, num_iterations=8, boosting=boosting)
    if boosting == "dart":
        kw.update(drop_rate=0.3, skip_drop=0.0)   # a drop every iteration
    metrics = {"ref": [], "port": []}
    for seed in range(4):
        ref_b, ref_base, _ = ref_fit_dist(x, y, RefParams(seed=seed, **kw),
                                          num_tasks=4)
        got_b, got_base, _ = fit_booster_distributed(
            x, y, BoostParams(seed=seed, **kw), mesh=_mesh())
        assert got_b.n_trees == ref_b.n_trees
        for key, m in (("ref", _margins(ref_b, ref_base, x)),
                       ("port", _margins(got_b, got_base, x))):
            metrics[key].append(
                (float(np.mean(np.logaddexp(0, m) - y * m)), _auc(m, y)))
    ref, port = np.mean(metrics["ref"], 0), np.mean(metrics["port"], 0)
    assert abs(ref[0] - port[0]) < 0.02, metrics
    assert abs(ref[1] - port[1]) < 0.01, metrics


def test_voting_elects_by_tally_with_ties_by_feature_id():
    """Two positions, each voting its own top-2: the tally's ties go to
    the lower feature id (a stable sort), and only elected features with
    a vote are marked."""
    cfg = trainer.TreeConfig(n_features=6, n_bins=4, max_depth=1,
                             min_data_in_leaf=1)
    rng = np.random.default_rng(9)

    def hists(best):
        # per-feature separable gradients: feature f's best gain grows
        # with best[f]
        hg = torch.zeros((1, 6, 4))
        for f, s in enumerate(best):
            hg[0, f] = torch.tensor([s, -s, s, -s]) + 0.01 * float(
                rng.normal())
        return hg, torch.ones((1, 6, 4)) * 5, torch.ones((1, 6, 4)) * 5
    local = [hists([5, 4, 0, 0, 3, 0]), hists([0, 4, 5, 0, 0, 3])]
    vidx, has_vote = trainer._voting_feature_mask(
        local, torch.ones(6, dtype=torch.bool), cfg, top_k=2)
    # tallies: f1 = 2, f0 = f2 = 1, the rest 0 -> elected f1, f0, f2, f3
    assert vidx.tolist() == [[1, 0, 2, 3]]
    assert has_vote.tolist() == [[True, True, True, False]]


def test_sharded_tree_fn_sums_positions():
    """`make_sharded_tree_fn` on 4 positions of the same rows grows the
    tree of the rows concatenated (sums of the same histograms)."""
    rng = np.random.default_rng(10)
    bins = torch.as_tensor(rng.integers(0, 16, (400, 5)), dtype=torch.uint8)
    grad = torch.as_tensor(rng.normal(size=400), dtype=torch.float32)
    hess = torch.ones(400)
    cfg = trainer.TreeConfig(n_features=5, n_bins=16, max_depth=3,
                             num_leaves=7, min_data_in_leaf=5)
    mask = torch.ones(5, dtype=torch.bool)
    want, want_delta = trainer.train_one_tree(bins, grad, hess, mask, cfg)
    fn = make_sharded_tree_fn(_mesh())
    got, deltas = fn(list(bins.chunk(4)), list(grad.chunk(4)),
                     list(hess.chunk(4)), mask, cfg)
    np.testing.assert_array_equal(got.split_feature, want.split_feature)
    np.testing.assert_array_equal(got.split_bin, want.split_bin)
    np.testing.assert_allclose(got.leaf_value, want.leaf_value, rtol=1e-5)
    np.testing.assert_allclose(torch.cat(deltas), want_delta, rtol=1e-5)
    with pytest.raises(ValueError, match="row shards"):
        fn([bins], [grad], [hess], mask, cfg)


def test_mesh_checkpoint_resume_is_bit_identical():
    """A checkpointed fit over the mesh, killed after 3 iterations and
    resumed from its checkpoint, equals the uninterrupted one bit for
    bit (fixed order, per-position draws keyed by the iteration)."""
    x, y = _data("binary", n=1003, seed=11)
    p = BoostParams(**dict(_COMMON, num_iterations=6, bagging_fraction=0.8,
                           bagging_freq=1))
    saved = {}

    def ck(it, booster, base, final=False, margin=None, rng_key=None):
        saved[it] = (booster, base, margin)
    full, base, _ = fit_booster_distributed(x, y, p, mesh=_mesh(),
                                            checkpoint_fn=ck,
                                            checkpoint_interval=3)
    b3, base3, m3 = saved[3]
    assert m3.shape == (1004,)
    resumed = {}

    def ck_resumed(it, booster, base, final=False, margin=None,
                   rng_key=None):
        resumed[it] = margin
    rest, _, _ = fit_booster_distributed(
        x, y, BoostParams(**dict(_COMMON, num_iterations=3,
                                 bagging_fraction=0.8, bagging_freq=1)),
        mesh=_mesh(), init_booster=b3, init_base=base3, init_margin=m3,
        iter_offset=3, checkpoint_fn=ck_resumed, checkpoint_interval=3)
    for f in ("split_feature", "split_bin", "leaf_value", "cover"):
        np.testing.assert_array_equal(getattr(rest, f), getattr(full, f))
    np.testing.assert_array_equal(resumed[3], saved[6][2])


def test_mesh_helpers_match_reference():
    a = np.arange(30, dtype=np.float32).reshape(10, 3)
    for mult, fill in ((4, 0), (5, 0), (3, -1)):
        got, n = parallel.pad_to_multiple(a, mult, fill=fill)
        want, m = ref_parallel.pad_to_multiple(a, mult, fill=fill)
        assert n == m
        np.testing.assert_array_equal(got, want)
    same, n = parallel.pad_to_multiple(a, 5)
    assert same is a and n == 10
    got_t, n = parallel.pad_to_multiple(torch.as_tensor(a), 4, fill=7)
    np.testing.assert_array_equal(got_t.numpy(),
                                  ref_parallel.pad_to_multiple(a, 4,
                                                               fill=7)[0])
    mesh = _mesh()
    pieces, n = parallel.shard_rows(mesh, a)
    ref_arr, ref_n = ref_parallel.shard_rows(ref_parallel.data_mesh(4), a)
    assert n == ref_n == 10 and len(pieces) == 4
    assert all(p.shape == (3, 3) and p.device.type == "cpu" for p in pieces)
    np.testing.assert_array_equal(torch.cat(pieces).numpy(),
                                  np.asarray(ref_arr))
    np.testing.assert_array_equal(
        parallel.valid_row_mask(12, 10, device="cpu").numpy(),
        np.asarray(ref_parallel.valid_row_mask(12, 10)))
    sh = parallel.row_sharding(mesh, ndim=2)
    assert sh.spec == ("data", None) and len(sh.devices()) == 4
    rep = parallel.replicated(mesh)
    assert rep.spec == () and len(rep.put(a)) == 1
    with pytest.raises(ValueError, match="pad"):
        sh.put(a)
    full = parallel.full_mesh(("model", "data"), devices=["cpu"] * 4)
    assert full.shape == {"model": 1, "data": 4}


def test_voting_estimator_over_two_cpu_positions_matches_reference():
    """`num_tasks=2`, which raised before the mesh was ported, fits over
    two positions in both packages."""
    x, y = _data("binary", n=1001, f=10, seed=12)
    kw = dict(_COMMON, num_iterations=3, parallelism="voting_parallel",
              top_k=2, num_tasks=2)
    got = GBDTClassifier(device="cpu", **kw).fit(
        Table({"features": x, "label": y}))
    ref = RefClassifier(quality_profile=False, **kw).fit(
        RefTable({"features": x, "label": y}))
    _assert_same_model(got.booster, ref.booster,
                       apply_bins(fit_bins(x, max_bin=63, seed=0), x))
