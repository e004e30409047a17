"""Histogram GBDT tree grower, level-wise over whole columns.

Port of `mmlspark_tpu/models/gbdt/trainer.py` (numeric splits):

- rows live on the device as (n, F) uint8 bins (`ops/binning.py`);
- per level, one histogram call builds grad/hess/count histograms for the
  level's nodes (`ops.histogram`, the CUDA kernel on the card); after
  depth 0 only LEFT children are built and siblings come from
  parent - left (LightGBM's subtraction trick);
- split search is a cumsum + closed-form gain over the whole (node,
  feature, bin) lattice at once;
- `num_leaves` is honoured by ranking a level's candidate splits and
  applying what the leaf budget allows.

The reference routes rows with select chains and one-hot matmuls because
per-row gathers serialise on a TPU; on the card one per-row gather does
it, for every level width. The level loop makes no host sync: counts and
the leaf budget stay tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops.histogram import node_feature_histograms


class TreeConfig(NamedTuple):
    """Hyperparameters of a single tree build (numeric splits)."""
    n_features: int
    n_bins: int = 256
    max_depth: int = 5
    num_leaves: int = 31
    learning_rate: float = 0.1
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3

    @property
    def max_nodes(self) -> int:
        return 2 ** (self.max_depth + 1) - 1


class Tree(NamedTuple):
    """One grown tree as dense heap arrays, all shape (max_nodes,)."""
    split_feature: torch.Tensor  # i32; -1 where the node is a leaf
    split_bin: torch.Tensor      # i32: go left if bin <= split_bin
    leaf_value: torch.Tensor     # f32 output where rows rest
    gain: torch.Tensor           # f32 split gain at internal nodes
    cover: torch.Tensor          # f32 row count through each node


def _soft_threshold(g, l1):
    return torch.sign(g) * torch.clamp(g.abs() - l1, min=0.0)


def _leaf_objective(g, h, cfg: TreeConfig):
    return _soft_threshold(g, cfg.lambda_l1) ** 2 / (h + cfg.lambda_l2)


def _gain_lattice(hg, hh, hc, feature_mask, cfg: TreeConfig,
                  parent_g, parent_h, parent_c):
    """Split gain over the (m nodes, F features, B bins) lattice; invalid
    candidates (min-data / min-hessian / masked features / empty right
    side) are -inf. LightGBM's gain formula, 1/2 factor included."""
    left_g = torch.cumsum(hg, dim=-1)
    left_h = torch.cumsum(hh, dim=-1)
    left_c = torch.cumsum(hc, dim=-1)
    tot_g = parent_g[:, None, None]
    tot_h = parent_h[:, None, None]
    tot_c = parent_c[:, None, None]
    right_g = tot_g - left_g
    right_h = tot_h - left_h
    right_c = tot_c - left_c
    gain = 0.5 * (_leaf_objective(left_g, left_h, cfg)
                  + _leaf_objective(right_g, right_h, cfg)
                  - _leaf_objective(tot_g, tot_h, cfg))
    ok = ((left_c >= cfg.min_data_in_leaf)
          & (right_c >= cfg.min_data_in_leaf)
          & (left_h >= cfg.min_sum_hessian_in_leaf)
          & (right_h >= cfg.min_sum_hessian_in_leaf)
          & feature_mask[None, :, None]
          & (right_c > 0))
    return torch.where(ok, gain, torch.full_like(gain, -torch.inf))


def _best_splits_for_level(hg, hh, hc, feature_mask, cfg: TreeConfig,
                           parent_g, parent_h, parent_c):
    """Per node: (best gain, feature, bin) over the numeric lattice. Ties
    take the first index, as `jnp.argmax` does."""
    m = hg.shape[0]
    gain = _gain_lattice(hg, hh, hc, feature_mask, cfg,
                         parent_g, parent_h, parent_c)
    flat = gain.reshape(m, -1)
    best_idx = torch.argmax(flat, dim=-1)
    best_gain = flat.gather(1, best_idx[:, None])[:, 0]
    return (best_gain, (best_idx // cfg.n_bins).to(torch.int32),
            (best_idx % cfg.n_bins).to(torch.int32))


def train_one_tree(bins: torch.Tensor, grad: torch.Tensor,
                   hess: torch.Tensor, feature_mask: torch.Tensor,
                   cfg: TreeConfig, count_w=None):
    """Grow one tree. grad/hess already fold in sample weights. `count_w`
    is the presence indicator for min_data_in_leaf counting (None = every
    row counts). Returns (Tree, delta) with delta = leaf_value of each
    row's resting node."""
    n = bins.shape[0]
    dev = bins.device
    i32 = torch.int32
    node_of_row = torch.zeros(n, dtype=torch.int64, device=dev)
    split_feature = torch.full((cfg.max_nodes,), -1, dtype=i32, device=dev)
    split_bin = torch.zeros(cfg.max_nodes, dtype=i32, device=dev)
    gain_arr = torch.zeros(cfg.max_nodes, dtype=torch.float32, device=dev)
    cover_arr = torch.zeros(cfg.max_nodes, dtype=torch.float32, device=dev)
    leaf_count = torch.ones((), dtype=torch.int64, device=dev)
    prev_hists = prev_apply = None

    def _interleave(left, sub):
        """(m/2,F,B) left-child + sibling hists -> (m,F,B) interleaved."""
        return torch.stack([left, sub], dim=1).reshape(
            left.shape[0] * 2, *left.shape[1:])

    for depth in range(cfg.max_depth):
        level_base = 2 ** depth - 1
        m = 2 ** depth
        node_local = node_of_row - level_base
        active = (node_local >= 0) & (node_local < m)

        if depth == 0:
            hg, hh, hc = node_feature_histograms(
                bins, grad, hess, node_local, active, m, cfg.n_bins,
                count_w=count_w)
            child_valid = torch.ones(m, dtype=torch.bool, device=dev)
        else:
            left_active = active & (node_local % 2 == 0)
            lg, lh, lc = node_feature_histograms(
                bins, grad, hess, node_local // 2, left_active, m // 2,
                cfg.n_bins, count_w=count_w)
            hg = _interleave(lg, prev_hists[0] - lg)
            hh = _interleave(lh, prev_hists[1] - lh)
            hc = _interleave(lc, prev_hists[2] - lc)
            # children of non-split nodes inherit garbage hists — mask them
            child_valid = torch.repeat_interleave(prev_apply, 2)
        parent_g = hg[:, 0].sum(-1)
        parent_h = hh[:, 0].sum(-1)
        parent_c = hc[:, 0].sum(-1)

        gain, feat, thr = _best_splits_for_level(
            hg, hh, hc, feature_mask, cfg, parent_g, parent_h, parent_c)
        gain = torch.where(child_valid, gain, torch.full_like(gain, -torch.inf))
        prev_hists = (hg, hh, hc)

        valid = (gain > cfg.min_gain_to_split) & torch.isfinite(gain)
        # leaf budget: each applied split adds one leaf; rank by gain with a
        # STABLE sort so ties rank as the reference's argsort ranks them
        order = torch.argsort(
            -torch.where(valid, gain, torch.full_like(gain, -torch.inf)),
            stable=True)
        rank = torch.argsort(order, stable=True)
        budget = cfg.num_leaves - leaf_count
        apply = valid & (rank < budget)
        leaf_count = leaf_count + apply.sum()
        prev_apply = apply

        sl = slice(level_base, level_base + m)
        split_feature[sl] = torch.where(apply, feat, -1)
        split_bin[sl] = torch.where(apply, thr, 0)
        gain_arr[sl] = torch.where(apply, gain, 0.0)
        cover_arr[sl] = torch.where(child_valid, parent_c, 0.0)

        # advance rows whose node split: one per-row gather of the node's
        # (feature, threshold, applied) and of the row's bin in that feature
        nl = node_local.clamp(0, m - 1)
        row_feat = feat.to(torch.int64)[nl]
        row_bin = bins.gather(1, row_feat[:, None])[:, 0].to(i32)
        go_left = row_bin <= thr[nl]
        child = torch.where(go_left, 2 * node_of_row + 1, 2 * node_of_row + 2)
        node_of_row = torch.where(active & apply[nl], child, node_of_row)

    # leaf values from resting nodes (shrinkage applied here, like LightGBM)
    cw = (count_w.to(torch.float32) if count_w is not None
          else torch.ones(n, dtype=torch.float32, device=dev))
    sums = torch.zeros((cfg.max_nodes, 3), dtype=torch.float32, device=dev)
    sums.index_add_(0, node_of_row,
                    torch.stack([grad.to(torch.float32),
                                 hess.to(torch.float32), cw], dim=1))
    seg_g, seg_h, seg_c = sums[:, 0], sums[:, 1], sums[:, 2]
    leaf_value = (-cfg.learning_rate * _soft_threshold(seg_g, cfg.lambda_l1)
                  / (seg_h + cfg.lambda_l2 + 1e-12))
    leaf_value = torch.where(seg_h > 0, leaf_value, 0.0)
    # deepest-level nodes never get a parent_c pass; their cover is the
    # resting-row count
    last_base = 2 ** cfg.max_depth - 1
    cover_arr[last_base:] = seg_c[last_base:]

    tree = Tree(split_feature=split_feature, split_bin=split_bin,
                leaf_value=leaf_value, gain=gain_arr, cover=cover_arr)
    return tree, leaf_value[node_of_row]


def _descend(feature_rows, split_feature, threshold, max_depth: int):
    """Resting heap node per row through one tree: `max_depth` steps of
    per-row gathers. Go left iff value <= threshold (NaN goes right);
    leaves stop the descent."""
    n, n_feat = feature_rows.shape
    sf = split_feature.to(torch.int64)
    node = torch.zeros(n, dtype=torch.int64, device=feature_rows.device)
    for _ in range(max_depth):
        f = sf[node]
        v = feature_rows.gather(1, f.clamp(0, n_feat - 1)[:, None])[:, 0]
        go_left = v <= threshold[node]
        child = torch.where(go_left, 2 * node + 1, 2 * node + 2)
        node = torch.where(f < 0, node, child)
    return node


def predict_binned(bins, split_feature, split_bin, leaf_value,
                   max_depth: int):
    """Score binned rows through one tree (train-time validation margins)."""
    node = _descend(bins.to(torch.int32), split_feature,
                    split_bin.to(torch.int32), max_depth)
    return leaf_value[node]


def predict_raw(x, split_feature, threshold, leaf_value, tree_class,
                max_depth: int, n_classes: int):
    """Ensemble raw scores on UNbinned f32 features; arrays are stacked
    over trees, (T, max_nodes). Thresholds are real-valued bin upper
    bounds, so no BinMapper is needed at serve time. Tree contributions
    add in tree order. Returns (n, n_classes) margins."""
    scores = torch.zeros((x.shape[0], n_classes), dtype=torch.float32,
                         device=x.device)
    for t in range(split_feature.shape[0]):
        node = _descend(x, split_feature[t], threshold[t], max_depth)
        k = int(tree_class[t])
        scores[:, k] = scores[:, k] + leaf_value[t][node]
    return scores
