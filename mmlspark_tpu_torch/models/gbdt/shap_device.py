"""Exact path-dependent TreeSHAP in torch ops, on the device.

Port of `mmlspark_tpu/models/gbdt/shap_device.py`, the same Algorithm 2
math (Lundberg, Erion & Lee 2018) as the host oracle
(`booster._tree_shap`), restructured so that nothing recurses:

- the heap layout makes every leaf's path structural, so each real leaf
  is one slot that walks its own path leaf -> root in `max_depth` steps;
  the reference's vmap over leaves is a leading batch dimension here,
  one row of (slots, rows) tensors per leaf, every tree of a group of
  trees in one batch;
- a feature met twice on a path is merged (fractions multiplied, the
  earlier element switched off) in place of Algorithm 2's unwind and
  re-extend: the extended subset weights are symmetric in their elements,
  so the merged set gives the same weights;
- EXTEND and UNWOUND_PATH_SUM run as masked loops of fixed bound (depth
  + 1), the active path length a per-slot tensor, with the reference's
  `safe_one` / `safe_zero` guards;
- the slots' contributions go into phi by one `index_add_` over the F + 1
  segments.

f32 throughout, as the reference. Rows go in chunks of 8192 (the
reference's), and trees in groups sized so that a group's (slots, depth,
rows) tensors stay under `_GROUP_ELEMENTS` elements: at depth 8 one tree
of 255 leaves and a chunk hold 255 x 8 x 8192 (16.7M) elements. The
tensors' device is the computation's: a CUDA tensor runs on the card, a
CPU tensor on the CPU; there is no kernel and no fallback.
"""
from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from . import trainer

# elements of one group's (slots, depth, rows) tensors
_GROUP_ELEMENTS = 1 << 25


def _extend_masked(pw, plen, z, o, active, max_len: int):
    """Masked Algorithm-2 EXTEND of one element, per slot. pw: a list of
    max_len + 1 (L, n) tensors (one per path slot); plen: (L,) i32, the
    elements already extended; z: (L,) zero fraction; o: (L, n) one
    fraction; active: (L,) bool, slots whose element is real."""
    new_pw = [torch.where(((plen == s) & active)[:, None],
                          (plen == 0).to(torch.float32)[:, None], pw[s])
              for s in range(max_len + 1)]
    plen_c = plen[:, None]
    z_c = z[:, None]
    for i in range(max_len - 1, -1, -1):
        live = ((i < plen) & active)[:, None]
        upd_next = o * new_pw[i] * (i + 1) / (plen_c + 1)
        new_pw[i + 1] = torch.where(live, new_pw[i + 1] + upd_next,
                                    new_pw[i + 1])
        new_pw[i] = torch.where(
            live, new_pw[i] * z_c * (plen_c - i) / (plen_c + 1), new_pw[i])
    return new_pw


def _unwound_sum(pw, plen_last, z, o, max_len: int):
    """Masked UNWOUND_PATH_SUM: the total pweight with the (z, o) element
    removed. plen_last: (L,) index of the last extended slot."""
    nonzero = o != 0
    safe_one = torch.where(nonzero, o, 1.0)
    zero_ok = (z != 0)[:, None]
    safe_zero = torch.where(z != 0, z, 1.0)[:, None]
    z_c = z[:, None]
    last = plen_last[:, None]
    nxt = pw[0] * 0.0
    for s in range(max_len + 1):
        nxt = torch.where(last == s, pw[s], nxt)
    total = torch.zeros_like(nxt)
    for i in range(max_len - 1, -1, -1):
        live = i < last
        tmp_a = nxt * (last + 1) / ((i + 1) * safe_one)
        nxt_a = pw[i] - tmp_a * z_c * (last - i) / (last + 1)
        tmp_b = torch.where(zero_ok,
                            (pw[i] / safe_zero) / ((last - i) / (last + 1)),
                            0.0)
        total = torch.where(live, total + torch.where(nonzero, tmp_a, tmp_b),
                            total)
        nxt = torch.where(live, torch.where(nonzero, nxt_a, nxt), nxt)
    return total


class _Slots:
    """The structure of a group of trees' real leaves, made once per call:
    every slot's path leaf -> root as (L, K) tensors, L = trees x slots,
    K = max_depth. `gpar` indexes the group's flattened (trees x
    max_nodes) routing bits."""

    def __init__(self, sf, lv, cover, max_depth: int, max_leaves: int):
        g, m = sf.shape
        dev = sf.device
        leaf_mask = (sf < 0) & (cover > 0)
        # each tree's real leaves first, padding after (resolved below to
        # non-leaf positions and switched off by `valid`)
        slots = torch.argsort((~leaf_mask).to(torch.int32), dim=1,
                              stable=True)[:, :max_leaves]          # (G, S)
        curs, pars = [], []
        cur = slots
        for _ in range(max_depth):
            par = torch.where(cur > 0, (cur - 1) // 2, 0)
            curs.append(cur)
            pars.append(par)
            cur = par
        cur_a = torch.stack(curs, dim=2)                          # (G, S, K)
        par_a = torch.stack(pars, dim=2)
        self.active = cur_a > 0                                   # above root
        is_left = cur_a == 2 * par_a + 1
        flat = lambda a: a.reshape(g, -1)                          # noqa: E731
        sf_par = flat(sf).gather(1, flat(par_a)).reshape(par_a.shape)
        self.feats = torch.where(self.active, sf_par, -1)
        cov_par = torch.clamp(
            flat(cover).gather(1, flat(par_a)).reshape(par_a.shape), min=1e-12)
        self.z0 = flat(cover).gather(1, flat(cur_a)).reshape(
            cur_a.shape) / cov_par
        # a real reachable leaf: marked a leaf, cover > 0, and every
        # ancestor edge it claims a real split
        self.valid = ((sf.gather(1, slots) < 0)
                      & (cover.gather(1, slots) > 0)
                      & torch.where(self.active, self.feats >= 0,
                                    True).all(dim=2))
        self.lv = lv.gather(1, slots)
        tree_base = (torch.arange(g, device=dev) * m)[:, None, None]
        self.gpar = par_a + tree_base
        self.is_left = is_left
        k = max_depth
        self.active, self.feats, self.z0, self.is_left, self.gpar = (
            a.reshape(-1, k) for a in (self.active, self.feats, self.z0,
                                       self.is_left, self.gpar))
        self.valid, self.lv = self.valid.reshape(-1), self.lv.reshape(-1)


def _route_left(x_t, sf, thr, ic, cw):
    """(G * max_nodes, n) go-left bits of every node of a group for every
    row: x <= threshold (NaN right); categorical nodes by membership of
    the raw id's bin (`trainer.raw_to_cat_bin`, `trainer.packed_member`),
    as every scoring path routes."""
    n_feat = x_t.shape[0]
    sf_f = sf.reshape(-1).to(torch.int64)
    v = x_t[sf_f.clamp(0, n_feat - 1)]                            # (G*M, n)
    go_left = v <= thr.reshape(-1)[:, None]
    if ic is not None:
        w16 = cw.shape[-1]
        member = trainer.packed_member(trainer.raw_to_cat_bin(v, w16),
                                       cw.reshape(-1, w16)[:, None, :])
        go_left = torch.where(ic.reshape(-1)[:, None], member, go_left)
    return go_left


def _slot_phi(sl: _Slots, go_left, n_features: int, max_depth: int):
    """The slots' contributions, (F + 1, n) f32: per slot, the duplicate
    merge, the masked EXTENDs of its path and one UNWOUND_PATH_SUM per
    element, then one `index_add_` over the F + 1 segments."""
    n = go_left.shape[1]
    k = max_depth
    max_len = k + 1
    hot = torch.where(sl.is_left[..., None], go_left[sl.gpar],
                      ~go_left[sl.gpar])                          # (L, K, n)
    z = [sl.z0[:, s] for s in range(k)]
    o = [hot[:, s].to(torch.float32) for s in range(k)]
    active = [sl.active[:, s] for s in range(k)]
    # merge duplicate features (multiply fractions, drop the earlier one)
    for s in range(k):
        for j in range(s):
            dup = active[j] & active[s] & (sl.feats[:, j] == sl.feats[:, s])
            z[s] = torch.where(dup, z[s] * z[j], z[s])
            o[s] = torch.where(dup[:, None], o[s] * o[j], o[s])
            active[j] = active[j] & ~dup
    n_slots = sl.feats.shape[0]
    dev = go_left.device
    # the root element: an empty path extended by (1, 1)
    pw = [torch.zeros((n_slots, n), dtype=torch.float32, device=dev)
          for _ in range(max_len + 1)]
    pw[0] = torch.ones_like(pw[0])
    plen = torch.ones(n_slots, dtype=torch.int32, device=dev)
    for s in range(k):
        pw = _extend_masked(pw, plen, z[s], o[s], active[s], max_len)
        plen = plen + active[s].to(torch.int32)
    plen_last = plen - 1
    lv = sl.lv[:, None]
    contrib = torch.stack([
        torch.where((active[s] & sl.valid)[:, None],
                    _unwound_sum(pw, plen_last, z[s], o[s], max_len)
                    * (o[s] - z[s][:, None]) * lv, 0.0)
        for s in range(k)], dim=1)                                 # (L, K, n)
    seg = sl.feats.clamp(0, n_features).reshape(-1)
    phi = torch.zeros((n_features + 1, n), dtype=torch.float32, device=dev)
    return phi.index_add_(0, seg, contrib.reshape(-1, n))


def _bias(sf, lv, cover, max_depth: int):
    """Each tree's expected value, (G,): the cover-weighted leaf mean (the
    host's `_cover_weighted_expectation`), 0 where no node has cover."""
    m = sf.shape[1]
    internal = (sf >= 0) & (torch.arange(m, device=sf.device)
                            < 2 ** max_depth - 1)
    w = cover * ((~internal) & (cover > 0))
    tot = w.sum(1)
    return torch.where(tot > 0, (lv * w).sum(1) / tot.clamp(min=1e-12), 0.0)


def shap_contributions_device(x, sf, thr, lv, cover, n_features: int,
                              max_depth: int, split_is_cat=None,
                              cat_words=None, row_chunk: int = 8192,
                              device=None) -> torch.Tensor:
    """(n, F) raw rows and (T, max_nodes) stacked trees (numpy or
    tensors) -> (n, F + 1) f32 exact path-dependent SHAP values as a
    tensor on `device` (None = the card); the last column is the bias.
    Rows go in chunks of `row_chunk`, trees in groups (module
    docstring)."""
    dev = resolve_device(device)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a, dtype=dtype).to(dev)
    sf = put(sf, torch.int32)
    thr, lv, cover = (put(a, torch.float32) for a in (thr, lv, cover))
    ic = cw = None
    if (split_is_cat is not None and cat_words is not None
            and np.shape(cat_words)[-1] > 0):
        ic, cw = put(split_is_cat, torch.bool), put(cat_words, torch.int32)
    x = put(x, torch.float32)
    n = x.shape[0]
    n_trees = sf.shape[0]
    phi = torch.zeros((n, n_features + 1), dtype=torch.float32, device=dev)
    if n_trees == 0 or n == 0:
        return phi
    # the widest real leaf count over the trees bounds the slots: a
    # 31-leaf depth-8 tree runs 31 slots, not its 256 heap leaves
    max_leaves = max(1, int(((sf < 0) & (cover > 0)).sum(1).max()))
    chunk = min(row_chunk, n)
    group = max(1, _GROUP_ELEMENTS // (max_leaves * max_depth * chunk))
    groups = []
    for g0 in range(0, n_trees, group):
        g = slice(g0, g0 + group)
        groups.append((g, _Slots(sf[g], lv[g], cover[g], max_depth,
                                 max_leaves)))
    bias = _bias(sf, lv, cover, max_depth).sum()
    for lo in range(0, n, chunk):
        x_t = x[lo:lo + chunk].T
        acc = torch.zeros((n_features + 1, x_t.shape[1]),
                          dtype=torch.float32, device=dev)
        for g, sl in groups:
            go_left = _route_left(x_t, sf[g], thr[g],
                                  None if ic is None else ic[g],
                                  None if cw is None else cw[g])
            acc += _slot_phi(sl, go_left, n_features, max_depth)
        acc[-1] += bias
        phi[lo:lo + chunk] = acc.T
    return phi
