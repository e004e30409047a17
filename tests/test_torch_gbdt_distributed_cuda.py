"""Device TreeSHAP and a data-parallel GBDT fit on the card.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gbdt_distributed_cuda.py
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models.gbdt import (BoostParams, fit_booster,
                                            fit_booster_distributed)
from mmlspark_tpu_torch.ops import histogram_cuda as hc
from mmlspark_tpu_torch.parallel import data_mesh

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_PARAMS = dict(objective="binary", num_iterations=4, max_depth=4,
               num_leaves=15, max_bin=63)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _data(n=200_000, f=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    z = x @ rng.normal(size=f) + 0.5 * x[:, 0] * x[:, 1]
    return x, (z + 0.3 * rng.normal(size=n) > 0).astype(np.float32)


@pytest.mark.gpu
def test_device_tree_shap_matches_host_oracle(cuda_device):
    """TreeSHAP in torch ops on the card within atol 1e-4 of the float64
    host oracle (the reference's limit), NaN rows included, and its rows
    sum to the raw score."""
    x, y = _data()
    booster, _, _ = fit_booster(x, y, BoostParams(**_PARAMS),
                                device=cuda_device)
    xs = x[:1024].copy()
    xs[:16, 0] = np.nan
    xs[16:32, 1] = 1e30
    got = booster.feature_contributions(xs, backend="device",
                                        device=cuda_device)
    want = booster.feature_contributions(xs, backend="host")
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(
        got.sum(1), booster.raw_score(xs, backend="host")[:, 0], atol=1e-4)


@pytest.mark.gpu
def test_two_position_fit_on_one_card_matches_one_position(cuda_device):
    """A data_parallel fit over two positions of the card launches the
    tiled kernel per position per level and takes the one-position fit's
    split features. Both add f32 atomics in no fixed order, so a split bin
    may flip where two bins' gains nearly tie (ROADMAP Queue 3 (e)): the
    recorded gains must then agree within rtol 1e-3, and the flip moves a
    few rows' margins (10 of 50,000 rows by up to 1.6e-4 on an NVIDIA
    H100 80GB HBM3 at 700 W).
    99.9% of the margins agree within rtol 1e-4, atol 1e-4, every
    margin within 1e-2, and the train logloss within 1e-4."""
    x, y = _data(seed=1)
    params = BoostParams(**_PARAMS)
    one, base1, _ = fit_booster(x, y, params, device=cuda_device)
    hc.reset_launches()
    two, base2, _ = fit_booster_distributed(
        x, y, params, mesh=data_mesh(devices=[cuda_device] * 2))
    torch.cuda.synchronize()
    assert hc.launches["hist_tiled"] == (2 * params.num_iterations
                                         * params.max_depth)
    assert base1 == base2
    np.testing.assert_array_equal(two.split_feature, one.split_feature)
    differ = two.split_bin != one.split_bin
    np.testing.assert_allclose(two.gain[differ], one.gain[differ],
                               rtol=1e-3)
    m1 = one.raw_score(x, base1, device=cuda_device)[:, 0]
    m2 = two.raw_score(x, base2, device=cuda_device)[:, 0]
    close = np.abs(m2 - m1) <= 1e-4 + 1e-4 * np.abs(m1)
    assert close.mean() >= 0.999 and np.abs(m2 - m1).max() < 1e-2
    ll1, ll2 = (float(np.mean(np.logaddexp(0, m) - y * m)) for m in (m1, m2))
    assert abs(ll1 - ll2) < 1e-4
