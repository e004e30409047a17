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

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)


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


def _kernel_and_plain(t, m, b, cw=None, plan=None):
    """The kernel and `_torch_hist_planes` on the same card tensors."""
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    lo = port.plan_lo_bins(b)
    plan = port.build_hist_plan(t[0], b) if plan is None else plan
    want = port._torch_hist_planes(*t[:5], m, b, count_w=cw,
                                   lo_planes=plan, plane_lo=lo)
    got = hc.hist_planes(*t[:5], m, b, count_w=cw, lo_planes=plan,
                         plane_lo=lo)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("with_count_w", [True, False])
@pytest.mark.parametrize("b", [64, 96, 256])
@pytest.mark.parametrize("m", range(1, port.PLANES_M_MAX + 1))
def test_planes_kernel_matches_plain(cuda_device, m, b, with_count_w):
    t = [torch.as_tensor(a).to(cuda_device)
         for a in _data(200_000, 12, m, b)]
    _assert_close(*_kernel_and_plain(t, m, b,
                                     t[5] if with_count_w else None))


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,m,b", [
    (10, 3, 2, 64),        # fewer rows than one 16-row step
    (63, 5, 4, 64),        # fewer than one 64-row tile
    (70_001, 12, 3, 96),   # a ragged last tile
    (20_000, 37, 4, 64),   # F past the 16-feature groups of HT = 2
    (20_000, 33, 2, 64),   # F past the 32-feature group of HT = 1
    (20_000, 9, 4, 256),   # F past the 4-feature groups of LO = 64
])
def test_planes_kernel_ragged_shapes(cuda_device, n, f, m, b):
    t = [torch.as_tensor(a).to(cuda_device) for a in _data(n, f, m, b)]
    _assert_close(*_kernel_and_plain(t, m, b, t[5]))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [64, 192])
def test_planes_kernel_drops_what_adds_nothing(cuda_device, b):
    """Every row inactive, or with a node past m, gives zeros; bins >= B
    (any value up to 255) add nothing, as in the plain version. B = 64
    and 192 take LO = 16 and 64."""
    bins, grad, hess, node, _, cw = _data(30_000, 8, 4, b, seed=3)
    for nd, act in ((np.full_like(node, -1), np.ones_like(node, bool)),
                    (node, np.zeros_like(node, bool)),
                    (np.full_like(node, 4), np.ones_like(node, bool))):
        t = [torch.as_tensor(a).to(cuda_device)
             for a in (bins, grad, hess, nd, act, cw)]
        got, _ = _kernel_and_plain(t, 4, b, t[5])
        assert all(float(x.abs().max()) == 0.0 for x in got)
    rng = np.random.default_rng(4)
    out = rng.random(bins.shape) < 0.1
    bins[out] = rng.integers(b, 256, size=int(out.sum()))
    t = [torch.as_tensor(a).to(cuda_device)
         for a in (bins, grad, hess, node, node >= 0, cw)]
    _assert_close(*_kernel_and_plain(t, 4, b, t[5]))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [64, 256])
def test_planes_kernel_takes_plan_values_as_factors(cuda_device, b):
    """Plan bytes 2, -1, -128 and 127 multiply the stats, as in the plain
    version: counts stay exact integer sums; grad/hess within 1e-4 of the
    sum of |stat x plan value| per bin (sums in another order, with
    cancellation)."""
    t = [torch.as_tensor(a).to(cuda_device)
         for a in _data(50_000, 8, 3, b, seed=5)]
    plan = port.build_hist_plan(t[0], b)
    r = torch.rand(plan.shape, device=cuda_device,
                   generator=torch.Generator(cuda_device).manual_seed(0))
    plan[(plan == 1) & (r < 0.3)] = 2
    plan[(plan == 0) & (r < 0.02)] = -1
    plan[(plan == 0) & (r > 0.995)] = -128
    plan[(plan == 0) & (r > 0.99) & (r <= 0.995)] = 127
    got, want = _kernel_and_plain(t, 3, b, t[5], plan=plan)
    assert torch.equal(got[2], want[2])
    mag = torch.where(plan == -128, 127, plan.abs()).to(torch.int8)
    scale = port._torch_hist_planes(t[0], t[1].abs(), t[2], *t[3:5], 3, b,
                                    lo_planes=mag,
                                    plane_lo=port.plan_lo_bins(b))
    for g, w, sc in zip(got[:2], want[:2], scale[:2]):
        assert bool(((g - w).abs() <= 1e-4 * sc + 1e-6).all())


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
    assert hc.launches == {"hist_tiled": 1, "hist_planes": 3,
                           "hist_tiled_fixed": 0, "hist_planes_fixed": 0}
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
    assert hc.launches == {"hist_tiled": 5, "hist_planes": 20,
                           "hist_tiled_fixed": 0, "hist_planes_fixed": 0}
    cpu, base_c, _ = fit_booster(x, y, p, device="cpu")
    assert base == base_c
    assert (gpu.split_feature == cpu.split_feature).mean() > 0.9
    np.testing.assert_allclose(
        gpu.raw_score(x, base, device=cuda_device),
        cpu.raw_score(x, base, backend="host"), atol=1e-3)
