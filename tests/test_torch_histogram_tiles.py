"""The tiled histogram kernel's planner and block loop, on the CPU.

`csrc/histogram.cu::hist_tile_kernel` runs only on the card; its launch is
planned in Python (`histogram_cuda.plan_tiles`, no card needed) and its
arithmetic is a sum of per-block partial histograms. Here:
- the planner, over m in {1, 2, 8, 64, 128, 512}, B in {16, 64, 256} and
  F in {1, 12, 32, 137} (and pinned knobs), puts every (node, feature) in
  exactly one tile, and no block asks for more than the H100's 232,448 B
  of shared memory;
- a torch emulation of the block loop (each tile's blocks take the rows
  the kernel's grid gives them, each warp its copy of the histograms, and
  the partials are summed) equals the port's `_torch_hist` and the JAX
  package's `_xla_hist` on the same seeded inputs: counts exactly, grad
  and hess at f32 tolerance (the sums run in another order);
- out-of-range bins (>= B) and rows whose node lies outside [0, m) add
  nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.histogram import _xla_hist
from mmlspark_tpu_torch.ops import histogram as port
from mmlspark_tpu_torch.ops import histogram_cuda as hc

# the H100's shared memory (cudaDevAttrMaxSharedMemoryPerBlockOptin, per
# SM) and SM count
_PER_BLOCK, _PER_SM, _SMS = 232_448, 233_472, 132


def _covered(plan, f, m):
    """How many tiles hold each (node, feature): (m, F) int."""
    cover = np.zeros((m, f), dtype=np.int64)
    for tn in range(plan.node_tiles):
        for tf in range(plan.feat_tiles):
            cover[tn * plan.mt:(tn + 1) * plan.mt,
                  tf * plan.ft:(tf + 1) * plan.ft] += 1
    return cover


@pytest.mark.parametrize("b", [16, 64, 256])
@pytest.mark.parametrize("m", [1, 2, 8, 64, 128, 512])
def test_planner_covers_every_node_feature_once(m, b):
    for f in (1, 12, 32, 137):
        for n in (1_000, 8_000_000):
            for knobs in ({}, dict(threads=256, copies=2),
                          dict(threads=512, ft=8), dict(copies=4, ft=1)):
                plan = hc.plan_tiles(n, f, m, b, _PER_BLOCK, _PER_SM, _SMS,
                                     **knobs)
                assert (_covered(plan, f, m) == 1).all(), (f, n, knobs, plan)
                assert plan.smem == hc.tile_smem(plan.mt, plan.ft, b,
                                                 plan.copies, plan.threads)
                assert plan.smem <= _PER_BLOCK, (f, n, knobs, plan)
                assert 1 <= plan.row_blocks <= 65535
                assert plan.copies >= 1 and plan.threads % 32 == 0


def test_planner_keeps_all_features_where_they_fit():
    """The headline's levels (8M x 32 x 64 bins, m <= 8) take one tile of
    every feature and node, so node and stats are read once a call; at
    m=128, B=256 the nodes are split and the features kept together."""
    for m in (1, 2, 4, 8):
        plan = hc.plan_tiles(8_000_000, 32, m, 64, _PER_BLOCK, _PER_SM, _SMS)
        assert (plan.node_tiles, plan.feat_tiles, plan.ft) == (1, 1, 32)
    plan = hc.plan_tiles(8_000_000, 32, 128, 256, _PER_BLOCK, _PER_SM, _SMS)
    assert plan.feat_tiles == 1 and plan.node_tiles > 1


def test_planner_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        hc.plan_tiles(100, 4, 1, 256, 40_000, _PER_SM, _SMS)


def _emulate_tiles(bins, grad, hess, node, active, m, b, count_w, plan):
    """The kernel's result as the sum of its blocks' partial histograms:
    block (tile, rb) takes the rows r with (r // threads) % row_blocks ==
    rb whose node lies in the tile's nodes, warp w of it adds into copy
    w % copies, and only bins < B add; every (tile, block, copy) partial is
    an f32 histogram, and the partials are summed into the output."""
    n, f = bins.shape
    nd = torch.where(active, node.long(), -1)
    r = torch.arange(n)
    block = (r // plan.threads) % plan.row_blocks
    copy = ((r % plan.threads) // 32) % plan.copies
    cnt = torch.ones(n) if count_w is None else count_w.float()
    outs = [torch.zeros(m, f, b) for _ in range(3)]
    for tn in range(plan.node_tiles):
        n0, n1 = tn * plan.mt, min(m, (tn + 1) * plan.mt)
        for tf in range(plan.feat_tiles):
            f0, f1 = tf * plan.ft, min(f, (tf + 1) * plan.ft)
            for rb in range(plan.row_blocks):
                for cp in range(plan.copies):
                    rows = ((nd >= n0) & (nd < n1) & (block == rb)
                            & (copy == cp))
                    bb = bins[rows, f0:f1].long()
                    keep = bb < b
                    key = ((nd[rows, None] - n0) * (f1 - f0)
                           + torch.arange(f1 - f0)) * b + bb
                    key = key[keep]
                    for o, s in zip(outs, (grad, hess, cnt)):
                        part = torch.zeros((n1 - n0) * (f1 - f0) * b)
                        part.index_add_(0, key, s[rows, None].expand(
                            -1, f1 - f0)[keep].float())
                        o[n0:n1, f0:f1] += part.reshape(n1 - n0, f1 - f0, b)
    return tuple(outs)


def _data(n, f, m, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, b, size=(n, f)).astype(np.uint8),
            rng.normal(size=n).astype(np.float32),
            rng.uniform(0.1, 1, size=n).astype(np.float32),
            rng.integers(-1, m, size=n).astype(np.int32),
            rng.integers(0, 2, size=n).astype(np.float32))


_CASES = [  # (n, F, m, B, knobs): one tile; nodes split; features split
    (3000, 32, 1, 64, dict(threads=128, copies=4)),
    (3000, 32, 8, 64, dict(threads=256)),
    (3000, 12, 128, 256, dict(threads=64, copies=2)),
    (2000, 137, 64, 256, dict(threads=96)),
    (2000, 32, 512, 64, dict(threads=512, ft=8)),
]


@pytest.mark.parametrize("with_cw", [False, True])
@pytest.mark.parametrize("n,f,m,b,knobs", _CASES)
def test_block_loop_matches_plain_and_xla(n, f, m, b, knobs, with_cw):
    bins, grad, hess, node, cw = _data(n, f, m, b, seed=n + f + m)
    active = node >= 0
    t = [torch.as_tensor(a) for a in (bins, grad, hess, node, active)]
    count_w = torch.as_tensor(cw) if with_cw else None
    plan = hc.plan_tiles(n, f, m, b, _PER_BLOCK, _PER_SM, _SMS, **knobs)
    got = _emulate_tiles(*t, m, b, count_w, plan)
    want = port._torch_hist(*t, m, b, count_w=count_w)
    xla = _xla_hist(jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
                    jnp.asarray(np.maximum(node, 0)), jnp.asarray(active),
                    m, b, jnp.asarray(cw) if with_cw else None)
    for ref in (want, tuple(torch.as_tensor(np.array(x)) for x in xla)):
        assert torch.equal(got[2], ref[2])
        for g, w in zip(got[:2], ref[:2]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_out_of_range_bins_and_nodes_add_nothing():
    """Bins >= B and nodes outside [0, m) of active rows are dropped, as
    the kernel drops them: the result is the plain histogram of the same
    rows with those entries taken out."""
    n, f, m, b = 3000, 12, 6, 64
    bins, grad, hess, node, _ = _data(n, f, m, b, seed=4)
    rng = np.random.default_rng(5)
    bins[rng.random((n, f)) < 0.1] = 200                 # >= B
    node[rng.random(n) < 0.1] = m + 3                    # past the last
    t = [torch.as_tensor(a) for a in (bins, grad, hess, node, node >= 0)]
    plan = hc.plan_tiles(n, f, m, b, _PER_BLOCK, _PER_SM, _SMS, threads=128,
                         copies=2)
    got = _emulate_tiles(*t, m, b, None, plan)
    want = [np.zeros((m, f, b), np.float64) for _ in range(3)]
    for r in range(n):
        if 0 <= node[r] < m:
            for j in range(f):
                if bins[r, j] < b:
                    for w, s in zip(want, (grad[r], hess[r], 1.0)):
                        w[node[r], j, bins[r, j]] += s
    assert torch.equal(got[2], torch.as_tensor(want[2], dtype=torch.float32))
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, torch.as_tensor(w, dtype=torch.float32),
                                   rtol=1e-5, atol=1e-5)
