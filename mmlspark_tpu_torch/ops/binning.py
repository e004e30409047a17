"""Quantile feature binning: float features -> uint8 bin ids + bin upper bounds.

Port of `mmlspark_tpu/ops/binning.py`. `BinMapper`, `fit_bins` and
`apply_bins` are the same numpy code (a copy: this package imports nothing
of the JAX package); `apply_bins_device` is one batched `torch.searchsorted`
on the device and gives bins equal to the host `apply_bins`, NaN and +-inf
included.

Bin semantics match LightGBM's: bin b holds values x <= upper_bound[b], the
last bin is +inf. NaN maps to the LAST bin of each feature (missing treated
as largest).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device


class BinMapper(NamedTuple):
    """Per-feature binning decided on (a sample of) the training data."""
    upper_bounds: np.ndarray   # (n_features, max_bin) f32; +inf padded
    n_bins: np.ndarray         # (n_features,) actual bin count used
    max_bin: int
    # bool (n_features,) — True columns hold integer category ids and are
    # binned by IDENTITY; None = all numeric
    categorical: Optional[np.ndarray] = None

    @property
    def n_features(self) -> int:
        return self.upper_bounds.shape[0]

    def _cat_mask(self) -> np.ndarray:
        if self.categorical is None:
            return np.zeros(self.n_features, bool)
        return self.categorical


def fit_bins(x: np.ndarray, max_bin: int = 255,
             sample_cnt: int = 200_000, seed: int = 2,
             categorical_features=()) -> BinMapper:
    """Choose at most max_bin quantile boundaries per feature, from a
    `sample_cnt`-row sample (LightGBM's `bin_construct_sample_cnt`).

    `categorical_features` columns are identity-binned: the value IS the
    category id, clipped to [0, max_bin]. NaN maps to the last bin.
    """
    n, f = x.shape
    if n > sample_cnt:
        rng = np.random.default_rng(seed)
        x = x[rng.choice(n, sample_cnt, replace=False)]
    ubs = np.full((f, max_bin), np.inf, dtype=np.float32)
    nbins = np.zeros(f, dtype=np.int32)
    cat_mask = np.zeros(f, dtype=bool)
    if len(categorical_features):
        cat_mask[np.asarray(categorical_features, int)] = True
    for j in range(f):
        if cat_mask[j]:
            nbins[j] = max_bin + 1
            ubs[j] = np.arange(max_bin, dtype=np.float32) + 0.5
            continue
        col = x[:, j]
        col = col[~np.isnan(col)]
        uniq = np.unique(col)
        if uniq.size <= 1:
            nbins[j] = 1
            continue
        if uniq.size <= max_bin:
            # distinct-value bins: boundary = midpoint between neighbors
            bounds = (uniq[:-1] + uniq[1:]) / 2.0
        else:
            # max_bin+1 grid points -> max_bin-1 interior boundaries
            qs = np.linspace(0, 1, max_bin + 1)[1:-1]
            bounds = np.unique(np.quantile(col, qs))
        k = min(bounds.size, max_bin - 1)
        ubs[j, :k] = bounds[:k]
        ubs[j, k:] = np.inf
        nbins[j] = k + 1
    return BinMapper(upper_bounds=ubs, n_bins=nbins, max_bin=max_bin,
                     categorical=cat_mask if cat_mask.any() else None)


def apply_bins(mapper: BinMapper, x: np.ndarray) -> np.ndarray:
    """Host bin assignment: (n_rows, n_features) -> uint8 bins.

    bin = searchsorted(upper_bounds, x, 'left'); NaN lands in the last bin.
    """
    n, f = x.shape
    out = np.empty((n, f), dtype=np.uint8)
    for j in range(f):
        k = int(mapper.n_bins[j])
        b = np.searchsorted(mapper.upper_bounds[j, : max(k - 1, 0)], x[:, j],
                            side="left")
        b = np.where(np.isnan(x[:, j]), k - 1, b)
        out[:, j] = b.astype(np.uint8)
    return out


def bin_threshold_value(mapper: BinMapper, feature: int, bin_id: int) -> float:
    """Real-valued decision threshold for 'go left if bin <= bin_id'."""
    return float(mapper.upper_bounds[feature, bin_id])


def apply_bins_device(mapper: BinMapper, x, device=None) -> torch.Tensor:
    """Device bin assignment: one batched searchsorted over the
    feature-major (F, n) view, then the NaN fix-up and the
    `min(b, n_bins - 1)` clamp of the reference's device version. The
    +inf padding of `upper_bounds` makes the full-width search equal to
    the host's search over the first n_bins-1 bounds. A NaN bound (the
    quantile of a column holding both infinities) sorts last in numpy's
    search but first in torch's, so it becomes +inf: it only ever sits
    after every finite bound, where +inf gives numpy's answer. Returns
    (n, F) uint8 on `device` (None = the card)."""
    dev = resolve_device(device)
    xd = torch.as_tensor(x, dtype=torch.float32).to(dev)
    ub = torch.as_tensor(mapper.upper_bounds, dtype=torch.float32).to(dev)
    ub = torch.where(torch.isnan(ub), torch.inf, ub)
    nb = torch.as_tensor(mapper.n_bins, dtype=torch.int64).to(dev)[:, None]
    xt = xd.t().contiguous()                               # (F, n)
    b = torch.searchsorted(ub, xt, side="left")            # (F, n) i64
    b = torch.where(torch.isnan(xt), nb - 1, b)
    b = torch.minimum(b, nb - 1)
    return b.to(torch.uint8).t().contiguous()
