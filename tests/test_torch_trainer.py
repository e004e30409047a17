"""Port parity: `train_one_tree` and the binned/raw descents
(`mmlspark_tpu_torch.models.gbdt.trainer`) against the JAX trainer, at
fixed grad/hess on continuous features (so no two candidate splits tie).

Tolerances: split_feature/split_bin/resting leaves equal; leaf_value,
gain, cover and the per-row delta within f32 summation tolerance
(rtol 1e-4, atol 1e-5: histogram and leaf sums add in another order).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmlspark_tpu.models.gbdt import trainer as ref
from mmlspark_tpu.ops.binning import apply_bins, fit_bins
from mmlspark_tpu_torch.models.gbdt import trainer as port

_TOL = dict(rtol=1e-4, atol=1e-5)


def _problem(n=2000, f=8, max_bin=63, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    bins = apply_bins(fit_bins(x, max_bin=max_bin), x)
    grad = (rng.normal(size=n) + x[:, 0] - 0.5 * x[:, 3]).astype(np.float32)
    hess = rng.uniform(0.2, 1.0, size=n).astype(np.float32)
    return x, bins, grad, hess


def _cfgs(f, max_bin, **kw):
    common = dict(n_features=f, n_bins=max_bin + 1, **kw)
    return ref.TreeConfig(**common), port.TreeConfig(**common)


@pytest.mark.parametrize("kw", [
    dict(max_depth=4, num_leaves=31, min_data_in_leaf=20),
    # leaf budget binds: the stable gain ranking decides which splits apply
    dict(max_depth=5, num_leaves=9, min_data_in_leaf=5, lambda_l2=1.0),
    dict(max_depth=3, num_leaves=8, min_data_in_leaf=10, lambda_l1=0.5,
         learning_rate=0.3, min_gain_to_split=0.05)])
@pytest.mark.parametrize("with_cw", [False, True])
def test_train_one_tree_matches_reference(kw, with_cw):
    x, bins, grad, hess = _problem()
    n, f = bins.shape
    cw = ((np.arange(n) % 7 != 0).astype(np.float32) if with_cw else None)
    cfg_r, cfg_p = _cfgs(f, 63, **kw)
    tree_r, delta_r = ref.train_one_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(f, bool), cfg_r,
        count_w=None if cw is None else jnp.asarray(cw))
    tree_p, delta_p = port.train_one_tree(
        torch.as_tensor(bins), torch.as_tensor(grad), torch.as_tensor(hess),
        torch.ones(f, dtype=torch.bool), cfg_p,
        count_w=None if cw is None else torch.as_tensor(cw))
    assert (np.asarray(tree_r.split_feature) >= 0).sum() > 2
    np.testing.assert_array_equal(tree_p.split_feature.numpy(),
                                  np.asarray(tree_r.split_feature))
    np.testing.assert_array_equal(tree_p.split_bin.numpy(),
                                  np.asarray(tree_r.split_bin))
    for name in ("leaf_value", "gain", "cover"):
        np.testing.assert_allclose(getattr(tree_p, name).numpy(),
                                   np.asarray(getattr(tree_r, name)),
                                   err_msg=name, **_TOL)
    np.testing.assert_allclose(delta_p.numpy(), np.asarray(delta_r), **_TOL)


def test_predict_binned_and_raw_match_reference():
    """Both descents on one reference tree: identical per-row values
    (the same f32 leaf values are gathered, no arithmetic)."""
    x, bins, grad, hess = _problem(seed=1)
    f = bins.shape[1]
    cfg_r, _ = _cfgs(f, 63, max_depth=4, num_leaves=12, min_data_in_leaf=10)
    tree, _ = ref.train_one_tree(jnp.asarray(bins), jnp.asarray(grad),
                                 jnp.asarray(hess), jnp.ones(f, bool), cfg_r)
    sf, sb, lv = (np.asarray(tree.split_feature), np.asarray(tree.split_bin),
                  np.asarray(tree.leaf_value))
    want = np.asarray(ref.predict_binned(jnp.asarray(bins), sf, sb, lv, 4))
    got = port.predict_binned(torch.as_tensor(bins), torch.as_tensor(sf),
                              torch.as_tensor(sb), torch.as_tensor(lv), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    # raw descent with real-valued thresholds, NaN rows routed right
    mapper = fit_bins(x, max_bin=63)
    thr = np.where(sf >= 0, mapper.upper_bounds[np.clip(sf, 0, f - 1),
                                                np.clip(sb, 0, 62)],
                   0.0).astype(np.float32)
    xn = x.copy()
    xn[::5, :] = np.nan
    tc = np.zeros(1, np.int32)
    want = np.asarray(ref.predict_raw(jnp.asarray(xn), sf[None], thr[None],
                                      lv[None], tc, 4, 1))
    got = port.predict_raw(torch.as_tensor(xn), torch.as_tensor(sf[None]),
                           torch.as_tensor(thr[None]),
                           torch.as_tensor(lv[None]), tc, 4, 1)
    np.testing.assert_array_equal(got.numpy(), want)
