"""Histogram GBDT tree grower, level-wise over whole columns.

Port of `mmlspark_tpu/models/gbdt/trainer.py`, numeric and native
categorical splits:

- rows live on the device as (n, F) uint8 bins (`ops/binning.py`);
- per level, one histogram call builds grad/hess/count histograms for the
  level's nodes (`ops.histogram`, the CUDA kernel on the card); after
  depth 0 only LEFT children are built and siblings come from
  parent - left (LightGBM's subtraction trick);
- split search is a cumsum + closed-form gain over the whole (node,
  feature, bin) lattice at once;
- `num_leaves` is honoured by ranking a level's candidate splits and
  applying what the leaf budget allows;
- categorical features (identity-binned category ids) search LightGBM's
  sorted one-vs-rest split: per node, a feature's bins are ordered by
  grad / (hess + cat_smooth) and the same cumsum search runs over the
  permuted lattice; the winning prefix, a set of categories, is packed
  into 16-bit membership words per node. The lattice is at most
  (m nodes, C features, B bins) and stays plain torch ops (a stable
  `argsort`, `cumsum`, `gather`), as the reference keeps it plain XLA.
  With no categorical feature none of this runs: the numeric program is
  unchanged.

The reference routes rows with select chains and one-hot matmuls because
per-row gathers serialise on a TPU; on the card one per-row gather does
it, for every level width. The level loop makes no host sync: counts and
the leaf budget stay tensors.

`fixed_order=True` (checkpointed fits) grows the same tree from the same
inputs on every call, as the reference's fixed-order XLA sums do, so that
a killed and resumed fit equals an uninterrupted one bit for bit. On the
card two steps add in no fixed order by default: the histogram kernels'
atomics and the leaf sums' `index_add_`. Fixed order takes the histogram
kernels' fixed-order forms and computes the leaf sums as a one-bin
histogram of every row's node with the same kernel. Everything else the
tree takes from the card is elementwise, a gather, a stable sort, a
reduction or a `cumsum` along the bin axis (one scan per (node, feature)
row), which add in one order; `chip_smoke.py [resume]` repeats those
cumsums on the card and fails if one ever differs.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ...ops.histogram import node_feature_histograms


class TreeConfig(NamedTuple):
    """Hyperparameters of a single tree build."""
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
    # native categorical splits: the listed features hold integer category
    # ids (identity-binned) and split on sets of categories
    categorical_features: tuple = ()
    cat_smooth: float = 10.0          # sort-ratio denominator smoothing
    cat_l2: float = 10.0              # extra L2 for categorical split gains
    max_cat_threshold: int = 32       # cap on the smaller side's categories

    @property
    def max_nodes(self) -> int:
        return 2 ** (self.max_depth + 1) - 1

    @property
    def cat_words_width(self) -> int:
        """16-bit membership words per node; 0 with no categorical
        feature (every categorical code path is then skipped)."""
        if not self.categorical_features:
            return 0
        return (self.n_bins + 15) // 16


class Tree(NamedTuple):
    """One grown tree as dense heap arrays, shape (max_nodes,) except
    cat_words (max_nodes, cat_words_width). The last two are None when the
    fit has no categorical feature."""
    split_feature: torch.Tensor  # i32; -1 where the node is a leaf
    split_bin: torch.Tensor      # i32: go left if bin <= split_bin
    leaf_value: torch.Tensor     # f32 output where rows rest
    gain: torch.Tensor           # f32 split gain at internal nodes
    cover: torch.Tensor          # f32 row count through each node
    split_is_cat: Optional[torch.Tensor] = None  # bool: route by membership
    cat_words: Optional[torch.Tensor] = None     # i32 packed 16-bit words


def _soft_threshold(g, l1):
    return torch.sign(g) * torch.clamp(g.abs() - l1, min=0.0)


def _leaf_objective(g, h, cfg: TreeConfig, l2=None):
    return _soft_threshold(g, cfg.lambda_l1) ** 2 / (
        h + (cfg.lambda_l2 if l2 is None else l2))


def _gain_lattice(hg, hh, hc, feature_mask, cfg: TreeConfig,
                  parent_g, parent_h, parent_c, l2=None):
    """Split gain over the (m nodes, F features, B bins) lattice; invalid
    candidates (min-data / min-hessian / masked features / empty right
    side) are -inf. LightGBM's gain formula, 1/2 factor included. `l2`:
    a per-feature (1, F, 1) L2 in place of cfg.lambda_l2."""
    left_g = torch.cumsum(hg, dim=-1)
    left_h = torch.cumsum(hh, dim=-1)
    left_c = torch.cumsum(hc, dim=-1)
    tot_g = parent_g[:, None, None]
    tot_h = parent_h[:, None, None]
    tot_c = parent_c[:, None, None]
    right_g = tot_g - left_g
    right_h = tot_h - left_h
    right_c = tot_c - left_c
    gain = 0.5 * (_leaf_objective(left_g, left_h, cfg, l2)
                  + _leaf_objective(right_g, right_h, cfg, l2)
                  - _leaf_objective(tot_g, tot_h, cfg, l2))
    ok = ((left_c >= cfg.min_data_in_leaf)
          & (right_c >= cfg.min_data_in_leaf)
          & (left_h >= cfg.min_sum_hessian_in_leaf)
          & (right_h >= cfg.min_sum_hessian_in_leaf)
          & feature_mask[None, :, None]
          & (right_c > 0))
    return torch.where(ok, gain, torch.full_like(gain, -torch.inf))


@functools.lru_cache(maxsize=16)
def _cat_tensors(cfg: TreeConfig, device: torch.device):
    """Made once per tree configuration rather than once per level: the
    categorical feature ids (C,) i64, the numeric-feature mask (F,), the
    (1, F + C, 1) L2 of the joint lattice (numeric features, then the
    sorted categorical ones with cat_l2 added) and prefix sizes 1..B."""
    cat = tuple(cfg.categorical_features)
    idx = torch.tensor(cat, dtype=torch.int64, device=device)
    num_mask = torch.ones(cfg.n_features, dtype=torch.bool, device=device)
    num_mask[idx] = False
    l2 = torch.tensor([cfg.lambda_l2] * cfg.n_features
                      + [cfg.lambda_l2 + cfg.cat_l2] * len(cat),
                      dtype=torch.float32, device=device)[None, :, None]
    sizes = torch.arange(1, cfg.n_bins + 1, device=device)[None, None, :]
    return idx, num_mask, l2, sizes


def _cat_sorted(hg, hh, hc, cat_idx, cfg: TreeConfig):
    """The categorical features' histograms with each (node, feature)'s
    bins ordered by grad / (hess + cat_smooth): (sorted grad, hess,
    count), the order, and the unsorted counts; each (m, C, B). Empty
    bins sort last, so they never hold a prefix position (unseen
    categories then route right, LightGBM's default); the sort is
    stable, as jnp.argsort is, so tied ratios order alike in both
    packages."""
    cat_h = torch.stack([hg, hh, hc])[:, :, cat_idx]          # (3, m, C, B)
    ratio = cat_h[0] / (cat_h[1] + cfg.cat_smooth)
    ratio = torch.where(cat_h[2] > 0, ratio, torch.inf)
    order = torch.argsort(ratio, dim=-1, stable=True)
    srt = cat_h.gather(-1, order.expand(3, *order.shape))
    return srt[0], srt[1], srt[2], order, cat_h[2]


def _cat_ok(ccn, sizes, cfg: TreeConfig):
    """max_cat_threshold: the smaller side of a categorical split holds at
    most this many categories (the prefix scan covers both directions)."""
    nnz = (ccn > 0).sum(-1, keepdim=True)                      # (m, C, 1)
    left_cats = torch.minimum(sizes, nnz)
    return ((left_cats <= cfg.max_cat_threshold)
            | (nnz - left_cats <= cfg.max_cat_threshold))


def _cat_gain_lattice(hg, hh, hc, feature_mask, cfg: TreeConfig,
                      parent_g, parent_h, parent_c):
    """Sorted-set categorical gain lattice. Returns (gain (m, C, B) over
    sorted prefix positions, the bins' sort order (m, C, B), the
    categorical count histograms (m, C, B))."""
    cat_idx, _, _, sizes = _cat_tensors(cfg, hg.device)
    sg, sh, sc, order, ccn = _cat_sorted(hg, hh, hc, cat_idx, cfg)
    cfg_cat = cfg._replace(lambda_l2=cfg.lambda_l2 + cfg.cat_l2)
    gain_cat = _gain_lattice(sg, sh, sc, feature_mask[cat_idx], cfg_cat,
                             parent_g, parent_h, parent_c)
    return (gain_cat.masked_fill(~_cat_ok(ccn, sizes, cfg), -torch.inf),
            order, ccn)


def _best_splits_for_level(hg, hh, hc, feature_mask, cfg: TreeConfig,
                           parent_g, parent_h, parent_c):
    """Per node: (best gain, feature, bin, is_cat, cat_words). Ties take
    the first index, as `jnp.argmax` does. With no categorical feature the
    last two are None and the search is the numeric lattice alone.

    A categorical candidate at sorted position p sends the p+1 lowest-ratio
    non-empty categories left; the winning set is packed into 16-bit
    words, bin b at bit b & 15 of word b >> 4. When B is not a multiple of
    16, the padding bins take the last bin's membership: a raw id past the
    top bin, or NaN, lands in a padding bin at serve time
    (`raw_to_cat_bin`), and in the last bin at train time
    (`ops.binning.apply_bins`), so both route alike."""
    m = hg.shape[0]
    F, B = cfg.n_features, cfg.n_bins
    if not cfg.categorical_features:
        gain = _gain_lattice(hg, hh, hc, feature_mask, cfg,
                             parent_g, parent_h, parent_c)
        flat = gain.reshape(m, -1)
        best_idx = torch.argmax(flat, dim=-1)
        best_gain = flat.gather(1, best_idx[:, None])[:, 0]
        return (best_gain, (best_idx // B).to(torch.int32),
                (best_idx % B).to(torch.int32), None, None)

    # one lattice over the numeric features and the sorted categorical
    # ones, (m, F + C, B): flattened, it is the reference's concatenation
    # of the numeric and categorical lattices, with the same gains
    cat_idx, num_mask, l2, sizes = _cat_tensors(cfg, hg.device)
    C = cat_idx.shape[0]
    sg, sh, sc, order, ccn = _cat_sorted(hg, hh, hc, cat_idx, cfg)
    gain = _gain_lattice(
        torch.cat([hg, sg], 1), torch.cat([hh, sh], 1),
        torch.cat([hc, sc], 1),
        torch.cat([feature_mask & num_mask, feature_mask[cat_idx]]), cfg,
        parent_g, parent_h, parent_c, l2=l2)
    gain[:, F:].masked_fill_(~_cat_ok(ccn, sizes, cfg), -torch.inf)
    flat = gain.reshape(m, -1)
    best_idx = torch.argmax(flat, dim=-1)
    best_gain = flat.gather(1, best_idx[:, None])[:, 0]
    is_cat = best_idx >= F * B
    cat_rel = (best_idx - F * B).clamp(0, C * B - 1)
    cidx, cpos = cat_rel // B, cat_rel % B
    feat = torch.where(is_cat, cat_idx[cidx], best_idx // B).to(torch.int32)
    thr = torch.where(is_cat, cpos, best_idx % B).to(torch.int32)

    # bin b goes left iff its rank in the winning feature's order is
    # <= cpos and the bin is non-empty
    take = cidx[:, None, None].expand(m, 1, B)
    order_win = order.gather(1, take)[:, 0]                       # (m, B)
    rank = torch.argsort(order_win, dim=-1, stable=True)          # inverse
    cc_win = ccn.gather(1, take)[:, 0]
    member = (rank <= cpos[:, None]) & (cc_win > 0) & is_cat[:, None]
    w16 = cfg.cat_words_width
    pad = w16 * 16 - B
    if pad:
        member = torch.cat([member, member[:, -1:].expand(m, pad)], dim=1)
    pow2 = 1 << torch.arange(16, dtype=torch.int32, device=hg.device)
    words = (member.reshape(m, w16, 16).to(torch.int32) * pow2).sum(
        -1, dtype=torch.int32)
    return best_gain, feat, thr, is_cat, words


def _member_bit(word, b):
    """Bit `b & 15` of `word`: the membership test of every path."""
    return ((word >> (b & 15)) & 1) == 1


def packed_member(b, words):
    """Membership bit of category bin `b` in packed 16-bit words.
    b: int (...) bin ids; words: int (..., W16) with leading dims
    broadcastable against b. A word index outside [0, W16) reads word 0,
    as the reference's where-chain does."""
    w16 = words.shape[-1]
    shape = torch.broadcast_shapes(b.shape, words.shape[:-1])
    b = torch.broadcast_to(b, shape)
    widx = (b >> 4).to(torch.int64)
    widx = torch.where((widx >= 0) & (widx < w16), widx, 0)
    word = torch.broadcast_to(words, (*shape, w16)).gather(
        -1, widx[..., None])[..., 0]
    return _member_bit(word, b)


def raw_to_cat_bin(x, w16: int):
    """Raw categorical value -> bin id, the reference's mapping: ceil(x -
    0.5) clipped to [0, 16 * w16 - 1], NaN to the top. For B = 16 * w16
    bins this is `ops.binning.apply_bins` of an identity-binned column
    exactly (negative ids share bin 0, ids past the top the last bin);
    otherwise ids past the top and NaN land in a padding bin, which holds
    the last bin's membership (`_best_splits_for_level`)."""
    top = w16 * 16 - 1
    b = torch.clamp(torch.ceil(x - 0.5), 0, top)
    return torch.where(torch.isnan(x), top, b).to(torch.int32)


def _cat_go_left(go_left, b, node, is_cat, words):
    """Categorical override of one routing step: one membership word per
    row, gathered from the flattened (nodes * W16) words at
    node * W16 + (b >> 4), never an (n, W16) block per row."""
    w16 = words.shape[-1]
    word = words.reshape(-1)[node * w16 + (b >> 4).to(torch.int64)]
    return torch.where(is_cat[node], _member_bit(word, b), go_left)


def train_one_tree(bins: torch.Tensor, grad: torch.Tensor,
                   hess: torch.Tensor, feature_mask: torch.Tensor,
                   cfg: TreeConfig, count_w=None, lo_planes=None,
                   plane_lo: int = 0, fixed_order: bool = False):
    """Grow one tree. grad/hess already fold in sample weights and
    bagging/GOSS row weights. `count_w` is the presence indicator for
    min_data_in_leaf counting (None = every row counts). `lo_planes`/
    `plane_lo`: the fit's histogram plan (`ops.histogram.build_hist_plan`),
    which every level of every tree reuses. `fixed_order`: the same tree
    from the same inputs on every call (the module docstring). Returns
    (Tree, delta) with delta = leaf_value of each row's resting node."""
    n = bins.shape[0]
    dev = bins.device
    i32 = torch.int32
    w16 = cfg.cat_words_width     # 0: no categorical code runs
    node_of_row = torch.zeros(n, dtype=torch.int64, device=dev)
    split_feature = torch.full((cfg.max_nodes,), -1, dtype=i32, device=dev)
    split_bin = torch.zeros(cfg.max_nodes, dtype=i32, device=dev)
    gain_arr = torch.zeros(cfg.max_nodes, dtype=torch.float32, device=dev)
    cover_arr = torch.zeros(cfg.max_nodes, dtype=torch.float32, device=dev)
    is_cat_arr = cat_words_arr = None
    if w16:
        is_cat_arr = torch.zeros(cfg.max_nodes, dtype=torch.bool, device=dev)
        cat_words_arr = torch.zeros((cfg.max_nodes, w16), dtype=i32,
                                    device=dev)
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
                count_w=count_w, lo_planes=lo_planes, plane_lo=plane_lo,
                fixed_order=fixed_order)
            child_valid = torch.ones(m, dtype=torch.bool, device=dev)
        else:
            left_active = active & (node_local % 2 == 0)
            lg, lh, lc = node_feature_histograms(
                bins, grad, hess, node_local // 2, left_active, m // 2,
                cfg.n_bins, count_w=count_w, lo_planes=lo_planes,
                plane_lo=plane_lo, fixed_order=fixed_order)
            hg = _interleave(lg, prev_hists[0] - lg)
            hh = _interleave(lh, prev_hists[1] - lh)
            hc = _interleave(lc, prev_hists[2] - lc)
            # children of non-split nodes inherit garbage hists — mask them
            child_valid = torch.repeat_interleave(prev_apply, 2)
        parent_g = hg[:, 0].sum(-1)
        parent_h = hh[:, 0].sum(-1)
        parent_c = hc[:, 0].sum(-1)

        gain, feat, thr, is_cat, words = _best_splits_for_level(
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
        if w16:
            applied_cat = apply & is_cat
            is_cat_arr[sl] = applied_cat
            cat_words_arr[sl] = torch.where(applied_cat[:, None], words, 0)

        # advance rows whose node split: one per-row gather of the node's
        # (feature, threshold, applied) and of the row's bin in that feature
        nl = node_local.clamp(0, m - 1)
        row_feat = feat.to(torch.int64)[nl]
        row_bin = bins.gather(1, row_feat[:, None])[:, 0].to(i32)
        go_left = row_bin <= thr[nl]
        if w16:
            go_left = _cat_go_left(go_left, row_bin, nl, is_cat, words)
        child = torch.where(go_left, 2 * node_of_row + 1, 2 * node_of_row + 2)
        node_of_row = torch.where(active & apply[nl], child, node_of_row)

    # leaf values from resting nodes (shrinkage applied here, like LightGBM)
    if fixed_order:
        # every row's node as a one-feature, one-bin histogram level of
        # max_nodes nodes: the histogram kernel's fixed-order form on the
        # card, `_torch_hist` on the CPU
        seg_g, seg_h, seg_c = (
            h[:, 0, 0] for h in node_feature_histograms(
                torch.zeros((n, 1), dtype=torch.uint8, device=dev), grad,
                hess, node_of_row, torch.ones(n, dtype=torch.bool,
                                              device=dev),
                cfg.max_nodes, 1, count_w=count_w, fixed_order=True))
    else:
        cw = (count_w.to(torch.float32) if count_w is not None
              else torch.ones(n, dtype=torch.float32, device=dev))
        sums = torch.zeros((cfg.max_nodes, 3), dtype=torch.float32,
                           device=dev)
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
                leaf_value=leaf_value, gain=gain_arr, cover=cover_arr,
                split_is_cat=is_cat_arr, cat_words=cat_words_arr)
    return tree, leaf_value[node_of_row]


def _has_cat(split_is_cat, cat_words) -> bool:
    return (split_is_cat is not None and cat_words is not None
            and cat_words.shape[-1] > 0)


def _descend(feature_rows, split_feature, threshold, max_depth: int,
             split_is_cat=None, cat_words=None, binned=False):
    """Resting heap node per row through one tree: `max_depth` steps of
    per-row gathers. Go left iff value <= threshold (NaN goes right);
    categorical nodes go left iff the value's bin (the bin itself when
    `binned`, else `raw_to_cat_bin`) is in the node's set; leaves stop
    the descent."""
    n, n_feat = feature_rows.shape
    sf = split_feature.to(torch.int64)
    cat = _has_cat(split_is_cat, cat_words)
    node = torch.zeros(n, dtype=torch.int64, device=feature_rows.device)
    for _ in range(max_depth):
        f = sf[node]
        v = feature_rows.gather(1, f.clamp(0, n_feat - 1)[:, None])[:, 0]
        go_left = v <= threshold[node]
        if cat:
            b = v if binned else raw_to_cat_bin(v, cat_words.shape[-1])
            go_left = _cat_go_left(go_left, b, node, split_is_cat,
                                   cat_words)
        child = torch.where(go_left, 2 * node + 1, 2 * node + 2)
        node = torch.where(f < 0, node, child)
    return node


def leaf_of_binned(bins, split_feature, split_bin, max_depth: int,
                   split_is_cat=None, cat_words=None):
    """Resting heap node per binned row through one tree (leaf-output
    renewal)."""
    return _descend(bins.to(torch.int32), split_feature,
                    split_bin.to(torch.int32), max_depth,
                    split_is_cat, cat_words, binned=True)


def predict_binned(bins, split_feature, split_bin, leaf_value,
                   max_depth: int, split_is_cat=None, cat_words=None):
    """Score binned rows through one tree (train-time validation margins)."""
    return leaf_value[leaf_of_binned(bins, split_feature, split_bin,
                                     max_depth, split_is_cat, cat_words)]


def predict_raw(x, split_feature, threshold, leaf_value, tree_class,
                max_depth: int, n_classes: int, split_is_cat=None,
                cat_words=None):
    """Ensemble raw scores on UNbinned f32 features; arrays are stacked
    over trees, (T, max_nodes) (cat_words (T, max_nodes, W16)).
    Thresholds are real-valued bin upper bounds, so no BinMapper is needed
    at serve time; categorical nodes test the raw category id's bin
    against their words. Tree contributions add in tree order. Returns
    (n, n_classes) margins."""
    scores = torch.zeros((x.shape[0], n_classes), dtype=torch.float32,
                         device=x.device)
    cat = _has_cat(split_is_cat, cat_words)
    for t in range(split_feature.shape[0]):
        node = _descend(x, split_feature[t], threshold[t], max_depth,
                        split_is_cat[t] if cat else None,
                        cat_words[t] if cat else None)
        k = int(tree_class[t])
        scores[:, k] = scores[:, k] + leaf_value[t][node]
    return scores
