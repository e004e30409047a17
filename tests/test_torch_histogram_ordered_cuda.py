"""The fixed-order histogram kernels on the card: bitwise repeatable, and
held against their plain versions.

`histogram_cuda.hist_tiled_fixed` and `hist_planes_fixed` add each
statistic as a 64-bit fixed-point integer, so two launches on the same
inputs must give `torch.equal` histograms, and a checkpointed tree (or
fit) grown twice must come out the same bit for bit. Every test here
carries the `gpu` marker and skips without a card; the file imports
neither jax nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_histogram_ordered_cuda.py
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


def _close(got, want):
    """Counts exact; grad/hess as the atomic kernel's test holds them
    (rtol 1e-4, atol 1e-3 over 200k rows): the plain version adds f32 in
    its own order, the fixed form rounds each term to 2^-(k - e)."""
    for w, g in zip(want[:2], got[:2]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)
    assert torch.equal(got[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("with_count_w", [True, False])
@pytest.mark.parametrize("m,b,f", [(1, 64, 32), (8, 64, 32), (64, 256, 12),
                                   (128, 256, 12), (512, 64, 12),
                                   (63, 1, 1)])
def test_tiled_fixed_repeats_and_matches_plain(cuda_device, m, b, f,
                                               with_count_w):
    """Two launches are equal bit for bit and match `_torch_hist`: the
    headline's levels (one tile), a node a tile (m=64, B=256), nodes split
    over tiles (m=128, B=256; m=512) and the leaf sums' shape (F=1, B=1,
    one node per heap node)."""
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    n = 200_000
    t = [torch.as_tensor(a).to(cuda_device) for a in _data(n, f, m, b)]
    cw = t[5] if with_count_w else None
    first = hc.hist_tiled_fixed(*t[:5], m, b, count_w=cw)
    again = hc.hist_tiled_fixed(*t[:5], m, b, count_w=cw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    _close(first, port._torch_hist(*t[:5], m, b, count_w=cw))


@pytest.mark.gpu
@pytest.mark.parametrize("with_count_w", [True, False])
@pytest.mark.parametrize("m,b", [(1, 64), (2, 64), (4, 64), (4, 256)])
def test_planes_fixed_repeats_and_matches_plain(cuda_device, m, b,
                                                with_count_w):
    """The planes form: two launches equal, and within the atomic planes
    kernel's limits of `_torch_hist_planes` (the same bf16 products)."""
    from mmlspark_tpu_torch.ops import histogram_cuda as hc
    n, f = 200_000, 32
    t = [torch.as_tensor(a).to(cuda_device) for a in _data(n, f, m, b)]
    cw = t[5] if with_count_w else None
    lo = port.plan_lo_bins(b)
    plan = port.build_hist_plan(t[0], b)
    kw = dict(count_w=cw, lo_planes=plan, plane_lo=lo)
    first = hc.hist_planes_fixed(*t[:5], m, b, **kw)
    again = hc.hist_planes_fixed(*t[:5], m, b, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    _close(first, port._torch_hist_planes(*t[:5], m, b, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("categorical", [False, True])
def test_fixed_order_tree_repeats(cuda_device, categorical):
    """`train_one_tree(fixed_order=True)` twice on the same inputs: every
    tree array and every row's delta equal bit for bit, numeric and with
    categorical features."""
    from mmlspark_tpu_torch.models.gbdt import trainer
    n, f, b = 300_000, 16, 64
    bins, grad, hess, _, _, cw = [torch.as_tensor(a).to(cuda_device)
                                  for a in _data(n, f, 1, b, seed=1)]
    cfg = trainer.TreeConfig(n_features=f, n_bins=b, max_depth=6,
                             num_leaves=40, categorical_features=(
                                 (12, 13, 14, 15) if categorical else ()))
    mask = torch.ones(f, dtype=torch.bool, device=cuda_device)
    runs = [trainer.train_one_tree(bins, grad, hess, mask, cfg, count_w=cw,
                                   fixed_order=True) for _ in range(2)]
    (t1, d1), (t2, d2) = runs
    for a, c in zip(t1, t2):
        assert (a is None and c is None) or torch.equal(a, c)
    assert torch.equal(d1, d2)


@pytest.mark.gpu
def test_checkpointed_fit_repeats(cuda_device):
    """Two fits with a checkpoint callback (hence fixed order), bagged
    and feature-subsampled, give the same booster bit for bit."""
    from mmlspark_tpu_torch.models.gbdt import BoostParams, fit_booster
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200_000, 16)).astype(np.float32)
    y = (x[:, 0] - x[:, 1] + rng.normal(size=len(x)) > 0).astype(np.float32)
    p = BoostParams(num_iterations=4, max_bin=63, bagging_fraction=0.8,
                    bagging_freq=1, feature_fraction=0.8)
    boosters = [fit_booster(x, y, p, device=cuda_device,
                            checkpoint_fn=lambda *a, **k: None)[0]
                for _ in range(2)]
    for field in ("split_feature", "threshold", "leaf_value"):
        assert np.array_equal(getattr(boosters[0], field),
                              getattr(boosters[1], field)), field
