"""The fixed-order histogram path on the CPU: its planner, its
fixed-point arithmetic and the trainer's fixed-order tree.

The fixed-order kernels (`histogram_cuda.hist_tiled_fixed`,
`hist_planes_fixed`) run only on the card (tests/
test_torch_histogram_ordered_cuda.py). What they compute is emulated here
with torch's int64 `index_add_`: every statistic rounded to an integer at
`fixed_scales`' power of two, the integers summed (exactly, so in any
order) and turned back to f32 by `_from_fixed`. The emulation must match
the plain version within the kernels' tolerance and be bitwise the same
for any row order; the planner's launches must fit the card; and
`train_one_tree(fixed_order=True)` must grow the reference's tree.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmlspark_tpu.models.gbdt import trainer as ref
from mmlspark_tpu.ops.binning import apply_bins, fit_bins
from mmlspark_tpu_torch.models.gbdt import trainer as port
from mmlspark_tpu_torch.ops import histogram as hist
from mmlspark_tpu_torch.ops import histogram_cuda as hc

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

# the H100's shared memory (opt-in per block, per SM) and SM count
_CARD = (232448, 233472, 132)


@pytest.mark.parametrize("n,f,m,b", [
    (8_000_000, 32, 1, 64), (8_000_000, 32, 8, 64), (8_000_000, 32, 16, 64),
    (2_270_296, 137, 64, 256), (8_000_000, 32, 128, 256),
    (8_000_000, 32, 512, 64), (8_000_000, 1, 63, 1), (8_000_000, 1, 4095, 1),
    (1000, 3, 2, 16)])
def test_fixed_plan_fits_the_card(n, f, m, b):
    """Every launch fits a block's shared memory with at least one copy,
    covers every node and feature, has positive row blocks, and the
    scratch is the three (m, F, B) int64 sums, whatever the row blocks
    (the ranker's widest level: 54 MB)."""
    plan = hc.plan_tiles(n, f, m, b, *_CARD, fixed=True)
    assert plan.smem <= _CARD[0]
    assert plan.smem == hc.tile_smem(plan.mt, plan.ft, b, plan.copies,
                                     plan.threads, fixed=True)
    assert plan.copies >= 1 and 1 <= plan.row_blocks <= 65535
    assert plan.node_tiles * plan.mt >= m and plan.feat_tiles * plan.ft >= f
    assert hc.fixed_scratch_bytes(m, f, b) == 24 * m * f * b
    assert hc.fixed_scratch_bytes(64, 137, 256) < 256 << 20
    # its cells are twice the atomic form's, so a tile holds at most as
    # many nodes
    atomic = hc.plan_tiles(n, f, m, b, *_CARD)
    assert plan.mt <= atomic.mt


def _data(n, f, m, b, seed=0):
    rng = np.random.default_rng(seed)
    bins = torch.as_tensor(rng.integers(0, b, size=(n, f)).astype(np.uint8))
    grad = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    hess = torch.as_tensor(rng.uniform(0.1, 1, size=n).astype(np.float32))
    node = torch.as_tensor(rng.integers(-1, m, size=n).astype(np.int32))
    cw = torch.as_tensor(rng.integers(0, 2, size=n).astype(np.float32))
    return bins, grad, hess, node, node >= 0, cw


def _emulate_fixed(bins, grad, hess, node, active, m, b, count_w=None):
    """The fixed-order kernels' arithmetic: each statistic rounded half
    to even at its scale (`__float2ll_rn`), summed as int64 per (node,
    feature, bin), turned back by `_from_fixed`."""
    n, f = bins.shape
    scale = hc.fixed_scales(n, (grad, hess, count_w))
    keys = ((node.long()[:, None] * f + torch.arange(f)[None, :]) * b
            + bins.long())
    keep = active[:, None].expand(n, f).reshape(-1)
    keys = keys.reshape(-1)[keep]
    outs = []
    for i, s in enumerate((grad, hess, count_w)):
        q = (torch.ones(n, dtype=torch.int64) if s is None
             else torch.round(s * scale[i]).to(torch.int64))
        acc = torch.zeros(m * f * b, dtype=torch.int64)
        acc.index_add_(0, keys, q[:, None].expand(n, f).reshape(-1)[keep])
        outs.append(acc.reshape(m, f, b))
    return hc._from_fixed(outs, scale)


@pytest.mark.parametrize("with_count_w", [False, True])
@pytest.mark.parametrize("m,b", [(1, 64), (8, 64), (63, 1), (64, 256)])
def test_fixed_point_sums_match_plain_in_any_order(m, b, with_count_w):
    """The fixed-point histograms against `_torch_hist` (counts exact,
    grad/hess within the card tests' rtol 1e-4, atol 1e-3), and equal bit
    for bit after shuffling the rows."""
    n, f = 50_000, (1 if b == 1 else 12)
    t = _data(n, f, m, b)
    cw = t[5] if with_count_w else None
    got = _emulate_fixed(*t[:5], m, b, count_w=cw)
    want = hist._torch_hist(*t[:5], m, b, count_w=cw)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-3)
    assert torch.equal(got[2], want[2])
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    shuffled = _emulate_fixed(*(x[perm] for x in t[:5]), m, b,
                              count_w=None if cw is None else cw[perm])
    assert all(torch.equal(x, y) for x, y in zip(got, shuffled))


def test_fixed_scales_bound_the_sums():
    """A term rounds to at most 2^k, k = 62 - bit_length(n), and above
    2^(k-1) for the largest |stat|: n terms into one cell stay below
    2^62; a count of None keeps scale 1; the scales are powers of two; a
    tiny statistic's scale stops at 2^126 (whose inverse f32 holds)."""
    n = 8_000_000
    grad = torch.full((n,), -3.5)
    hess = torch.full((n,), 0.7)
    s = hc.fixed_scales(n, (grad, hess, None))
    assert s[2] == 1.0
    assert torch.equal(torch.frexp(s).mantissa, torch.full((3,), 0.5))
    k = 62 - n.bit_length()
    for stat, scale in ((grad, s[0]), (hess, s[1])):
        q = torch.round(stat[:1] * scale).to(torch.int64).abs()
        assert int(q) <= 2 ** k and int(q) * n < 2 ** 62
        assert int(q) > 2 ** (k - 1)      # no precision left unused
    tiny = hc.fixed_scales(n, (torch.full((n,), 1e-30), hess, None))
    assert tiny[0] == 2.0 ** 126
    assert float((1e-30 * tiny[0]).abs()) < 2 ** k


def test_cpu_fixed_order_is_the_plain_version():
    """On the CPU, fixed_order routes to the plain versions, which already
    add in one order."""
    t = _data(20_000, 8, 4, 64)
    plan = hist.build_hist_plan(t[0], 64)
    for kw in ({}, dict(lo_planes=plan, plane_lo=16)):
        a = hist.node_feature_histograms(*t[:5], 4, 64, count_w=t[5],
                                         fixed_order=True, **kw)
        b = hist.node_feature_histograms(*t[:5], 4, 64, count_w=t[5], **kw)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("categorical", [False, True])
def test_fixed_order_tree_matches_reference(categorical):
    """`train_one_tree(fixed_order=True)`: the fixed-order histograms and
    the leaf sums as a one-bin histogram grow the reference's tree (split features and bins equal, values within f32
    summation tolerance, rtol 1e-4, atol 1e-5)."""
    rng = np.random.default_rng(3)
    n, f = 2000, 8
    x = rng.normal(size=(n, f)).astype(np.float32)
    cat = (6, 7) if categorical else ()
    for c in cat:
        x[:, c] = rng.integers(0, 20, size=n)
    bins = apply_bins(fit_bins(x, max_bin=63, categorical_features=cat), x)
    grad = (rng.normal(size=n) + x[:, 0] + 0.3 * (x[:, 7] % 3)).astype(
        np.float32)
    hess = rng.uniform(0.2, 1.0, size=n).astype(np.float32)
    cw = (np.arange(n) % 7 != 0).astype(np.float32)
    kw = dict(n_features=f, n_bins=64, max_depth=4, num_leaves=15,
              min_data_in_leaf=10, categorical_features=cat)
    tree_r, delta_r = ref.train_one_tree(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(f, bool), ref.TreeConfig(**kw), count_w=jnp.asarray(cw))
    tree_p, delta_p = port.train_one_tree(
        torch.as_tensor(bins), torch.as_tensor(grad), torch.as_tensor(hess),
        torch.ones(f, dtype=torch.bool), port.TreeConfig(**kw),
        count_w=torch.as_tensor(cw), fixed_order=True)
    assert (np.asarray(tree_r.split_feature) >= 0).sum() > 2
    for name in ("split_feature", "split_bin"):
        np.testing.assert_array_equal(getattr(tree_p, name).numpy(),
                                      np.asarray(getattr(tree_r, name)))
    if categorical:
        assert tree_p.split_is_cat.any()
        np.testing.assert_array_equal(tree_p.cat_words.numpy(),
                                      np.asarray(tree_r.cat_words))
    for name in ("leaf_value", "gain", "cover"):
        np.testing.assert_allclose(getattr(tree_p, name).numpy(),
                                   np.asarray(getattr(tree_r, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(delta_p.numpy(), np.asarray(delta_r),
                               rtol=1e-4, atol=1e-5)
