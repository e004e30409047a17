"""Sorted-levels lookup shared by every categorical indexer.

A copy of `mmlspark_tpu/ops/levels.py` (host numpy): one implementation
of the searchsorted/clip/verify pattern, so missing-value and dtype
subtleties are fixed in one place.
"""
from __future__ import annotations

import numpy as np


def lookup_levels(levels: np.ndarray, vals: np.ndarray):
    """(indices, found): position of each value in sorted `levels`; `found`
    False where the value is absent (caller decides the policy)."""
    levels = np.asarray(levels)
    vals = np.asarray(vals)
    idx = np.searchsorted(levels, vals)
    idx = np.clip(idx, 0, max(len(levels) - 1, 0))
    found = levels[idx] == vals if len(levels) else np.zeros(vals.shape, bool)
    return idx.astype(np.int64), found
