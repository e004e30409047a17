"""The CUDA histogram kernels against the plain version, on the card.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_histogram_cuda.py
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


@pytest.mark.gpu
@pytest.mark.parametrize("with_count_w", [True, False])
@pytest.mark.parametrize("kernel,m,b", [("hist_tiled", 1, 64),
                                        ("hist_tiled", 8, 64),
                                        ("hist_tiled", 64, 256),
                                        ("hist_tiled", 128, 256),
                                        ("hist_tiled", 512, 64)])
def test_cuda_kernel_matches_plain(cuda_device, kernel, m, b, with_count_w):
    """The CUDA entry point against `_torch_hist` on the same CUDA
    tensors, with a count_w and without one (as the trainer calls it), at
    one tile of every feature (m = 1, 8), one node per tile (m=64, B=256)
    and nodes split over tiles (m=128, B=256; m=512). Counts are exact
    (integer sums below 2^24); grad/hess sums differ by f32 atomic order:
    rtol 1e-4, atol 1e-3 over 200k rows."""
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    n, f = 200_000, 12
    t = [torch.as_tensor(a).to(cuda_device) for a in _data(n, f, m, b)]
    cw = t[5] if with_count_w else None
    want = port._torch_hist(*t[:5], m, b, count_w=cw)
    got = getattr(hc, kernel)(*t[:5], m, b, count_w=cw)
    torch.cuda.synchronize()
    for w, g in zip(want[:2], got[:2]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)
    assert torch.equal(got[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("f,ft,threads,copies", [(12, 4, 256, 2),
                                                 (137, 69, 512, 1),
                                                 (137, 1, 1024, 4),
                                                 (32, 16, 1024, 3)])
def test_tile_plans_match_plain(cuda_device, f, ft, threads, copies):
    """Launches away from the planner's choice (features per tile, more
    and fewer than a warp's lanes; threads; copies) against the plain
    version."""
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    n, m, b = 50_000, 6, 64
    t = [torch.as_tensor(a).to(cuda_device) for a in _data(n, f, m, b)]
    plan = hc.plan_tiles(n, f, m, b, *hc._card(0), threads=threads,
                         copies=copies, ft=ft)
    want = port._torch_hist(*t[:5], m, b)
    ops, got = hc._prepare(*t[:5], m, b, None)
    hc._launch_tiled(ops, got, n, f, m, b, plan)
    for w, g in zip(want[:2], got[:2]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)
    assert torch.equal(got[2], want[2])


@pytest.mark.gpu
def test_dispatch_launches_kernel_and_counts(cuda_device):
    """A CUDA tensor goes to the tiled kernel (never the plain version) at
    every m*B, including one that outgrows a block, and each launch
    counts."""
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    t = [torch.as_tensor(a).to(cuda_device) for a in _data(5000, 4, 4, 64)]
    hc.reset_launches()
    port.node_feature_histograms(*t[:5], 4, 64, count_w=t[5])
    assert hc.launches == {"hist_tiled": 1, "hist_planes": 0,
                           "hist_tiled_fixed": 0, "hist_planes_fixed": 0}
    port.node_feature_histograms(*t[:5], 512, 64)
    assert hc.launches == {"hist_tiled": 2, "hist_planes": 0,
                           "hist_tiled_fixed": 0, "hist_planes_fixed": 0}


@pytest.mark.gpu
def test_fit_on_card_matches_cpu(cuda_device):
    """A small fit on the card (kernel histograms) against the same fit
    on the CPU (plain histograms): same trees up to near-tie flips, train
    margins within 1e-3."""
    from mmlspark_tpu_torch.models.gbdt import BoostParams, fit_booster
    rng = np.random.default_rng(0)
    x = rng.normal(size=(20_000, 8)).astype(np.float32)
    y = (x @ rng.normal(size=8) > 0).astype(np.float32)
    p = BoostParams(num_iterations=5, max_bin=63, max_depth=5)
    gpu, base, _ = fit_booster(x, y, p, device=cuda_device)
    cpu, base_c, _ = fit_booster(x, y, p, device="cpu")
    assert base == base_c
    assert (gpu.split_feature == cpu.split_feature).mean() > 0.9
    np.testing.assert_allclose(
        gpu.raw_score(x, base, device=cuda_device),
        cpu.raw_score(x, base, backend="host"), atol=1e-3)
