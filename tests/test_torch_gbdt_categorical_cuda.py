"""A categorical GBDT fit on the card against the same fit on the plain
histograms.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gbdt_categorical_cuda.py
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models.gbdt import BoostParams, fit_booster, trainer
from mmlspark_tpu_torch.ops import histogram as hist
from mmlspark_tpu_torch.ops import histogram_cuda as hc

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cat_data(n=200_000, seed=0, levels=(24, 40)):
    """Four numeric columns and two categorical ones (4, 5) whose effects
    are seeded permutations of evenly spaced values (no ratio near-ties)."""
    rng = np.random.default_rng(seed)
    x_num = rng.normal(size=(n, 4)).astype(np.float32)
    cats = [rng.integers(0, k, n) for k in levels]
    effs = [rng.permutation(np.linspace(-1, 1, k)) for k in levels]
    z = sum(e[c] for e, c in zip(effs, cats)) + 0.5 * x_num[:, 0] \
        + 0.3 * rng.normal(size=n)
    x = np.column_stack([x_num] + [c.astype(np.float32) for c in cats])
    return x, (z > 0).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["tiled", "planes"])
def test_categorical_fit_matches_plain_histograms(cuda_device, monkeypatch,
                                                  route):
    """The kernels' fit and the plain-histogram fit on the card take the
    same categorical splits (features, split_is_cat, words); margins
    within rtol 1e-4, atol 1e-4 (f32 atomic sums in another order); every
    level launched a kernel."""
    if route == "planes":
        monkeypatch.setenv("MMLSPARK_TPU_HIST", "planes")
    x, y = _cat_data()
    params = BoostParams(objective="binary", num_iterations=4, max_depth=4,
                         num_leaves=15, max_bin=63, categorical_features=(4, 5))
    hc.reset_launches()
    got, base, _ = fit_booster(x, y, params, device=cuda_device)
    torch.cuda.synchronize()
    launched = sum(hc.launches.values())
    assert launched == params.num_iterations * params.max_depth
    if route == "planes":
        assert hc.launches["hist_planes"] > 0

    def plain(bins, grad, hess, node_local, active, n_nodes, n_bins,
              count_w=None, lo_planes=None, plane_lo=0, fixed_order=False):
        # the plain versions add in a fixed order already
        if hist.planes_route(n_nodes, n_bins, lo_planes is not None):
            return hist._torch_hist_planes(
                bins, grad, hess, node_local, active, n_nodes, n_bins,
                count_w=count_w, lo_planes=lo_planes, plane_lo=plane_lo)
        return hist._torch_hist(bins, grad, hess, node_local, active,
                                n_nodes, n_bins, count_w=count_w)
    monkeypatch.setattr(trainer, "node_feature_histograms", plain)
    hc.reset_launches()
    want, want_base, _ = fit_booster(x, y, params, device=cuda_device)
    assert not any(hc.launches.values())
    assert got.split_is_cat.any()
    np.testing.assert_array_equal(got.split_feature, want.split_feature)
    np.testing.assert_array_equal(got.split_is_cat, want.split_is_cat)
    np.testing.assert_array_equal(got.cat_words, want.cat_words)
    np.testing.assert_allclose(
        got.raw_score(x, base, backend="device", device=cuda_device),
        want.raw_score(x, want_base, backend="device", device=cuda_device),
        rtol=1e-4, atol=1e-4)
    # device and host scoring rest every row in the same leaf
    np.testing.assert_allclose(
        got.raw_score(x[:2000], base, backend="device", device=cuda_device),
        got.raw_score(x[:2000], base, backend="host"), rtol=1e-6, atol=1e-6)
