"""The CUDA planes kernel (`hist_planes`) against its plain version
`_torch_hist_planes`, on the card.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_histogram_planes_cuda.py
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import histogram as port


def _data(n, f, m, b, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, b, size=(n, f)).astype(np.uint8)
    grad = rng.normal(size=n).astype(np.float32)
    hess = rng.uniform(0.1, 1, size=n).astype(np.float32)
    node = rng.integers(-1, m, size=n).astype(np.int32)
    cw = rng.integers(0, 2, size=n).astype(np.float32)
    return bins, grad, hess, node, node >= 0, cw


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_close(got, want):
    """Counts exact (integer sums below 2^24); grad/hess are sums of the
    same bf16-rounded values in another order (atomics against a cuBLAS
    product): rtol 1e-4, atol 1e-3 over 200k rows."""
    for w, g in zip(want[:2], got[:2]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)
    assert torch.equal(got[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("with_count_w", [True, False])
@pytest.mark.parametrize("m,b", [(1, 64), (2, 64), (4, 64), (4, 96),
                                 (1, 256), (4, 256)])
def test_planes_kernel_matches_plain(cuda_device, m, b, with_count_w):
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    t = [torch.as_tensor(a).to(cuda_device)
         for a in _data(200_000, 12, m, b)]
    cw = t[5] if with_count_w else None
    lo = port.plan_lo_bins(b)
    plan = port.build_hist_plan(t[0], b)
    want = port._torch_hist_planes(*t[:5], m, b, count_w=cw,
                                   lo_planes=plan, plane_lo=lo)
    got = hc.hist_planes(*t[:5], m, b, count_w=cw, lo_planes=plan,
                         plane_lo=lo)
    torch.cuda.synchronize()
    _assert_close(got, want)


@pytest.mark.gpu
def test_shifted_plan_is_caught(cuda_device):
    """The kernel reads lo from the plan: a plan of the bins shifted by
    one row gives other histograms, which the check above rejects."""
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    t = [torch.as_tensor(a).to(cuda_device) for a in _data(200_000, 12, 2,
                                                             64)]
    plan = port.build_hist_plan(t[0], 64)
    want = port._torch_hist_planes(*t[:5], 2, 64, lo_planes=plan,
                                   plane_lo=16)
    shifted = port.build_hist_plan(torch.roll(t[0], 1, 0), 64)
    got = hc.hist_planes(*t[:5], 2, 64, lo_planes=shifted, plane_lo=16)
    torch.cuda.synchronize()
    with pytest.raises(AssertionError):
        _assert_close(got, want)


@pytest.mark.gpu
def test_dispatch_launches_planes_kernel_and_counts(cuda_device):
    """With a plan, levels of at most PLANES_M_MAX nodes launch the planes
    kernel, deeper ones the tiled kernel; each launch counts."""
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    t = [torch.as_tensor(a).to(cuda_device) for a in _data(5000, 4, 8, 64)]
    plan = port.build_hist_plan(t[0], 64)
    hc.reset_launches()
    for m in (1, 2, 4, 8):
        port.node_feature_histograms(*t[:5], m, 64, count_w=t[5],
                                     lo_planes=plan, plane_lo=16)
    assert hc.launches == {"hist_tiled": 1, "hist_planes": 3}
    with pytest.raises(ValueError, match="plan"):
        port.node_feature_histograms(*t[:5], 2, 64, lo_planes=plan[:, :10],
                                     plane_lo=16)


@pytest.mark.gpu
def test_planes_fit_on_card_matches_cpu(cuda_device, monkeypatch):
    """A small fit under MMLSPARK_TPU_HIST=planes on the card (kernel
    histograms) against the same fit on the CPU (plain planes histograms;
    no bagging, since the CPU and CUDA generators draw other numbers):
    near-tie flips only, train margins within 1e-3."""
    from mmlspark_tpu_torch.models.gbdt import BoostParams, fit_booster
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    monkeypatch.setenv("MMLSPARK_TPU_HIST", "planes")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(20_000, 8)).astype(np.float32)
    y = (x @ rng.normal(size=8) > 0).astype(np.float32)
    p = BoostParams(num_iterations=5, max_bin=63, max_depth=5)
    hc.reset_launches()
    gpu, base, _ = fit_booster(x, y, p, device=cuda_device)
    assert hc.launches == {"hist_tiled": 5, "hist_planes": 20}
    cpu, base_c, _ = fit_booster(x, y, p, device="cpu")
    assert base == base_c
    assert (gpu.split_feature == cpu.split_feature).mean() > 0.9
    np.testing.assert_allclose(
        gpu.raw_score(x, base, device=cuda_device),
        cpu.raw_score(x, base, backend="host"), atol=1e-3)
