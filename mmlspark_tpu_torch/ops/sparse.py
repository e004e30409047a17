"""Static-width sparse feature pairs: the framework-wide sparse convention.

Port of `mmlspark_tpu/ops/sparse.py`. A sparse feature column is a PAIR
of dense arrays `<name>_idx` (n, W) int32 and `<name>_val` (n, W) f32
with a schema-static width W; empty slots carry val 0 (their idx is
irrelevant). `DENSE_AUTO_LIMIT` and `rows_to_pair` are host code, copied.

`to_dense` runs on the card. The reference scatters with `.at[].add`;
here the sum of colliding slots is deterministic: the flat keys
`row * width + col` are sorted stably, each run of equal keys is summed
by one `torch.segment_reduce`, and the sums are written to distinct
slots. No float atomics, so two calls give the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

# policy shared by every featurizer with a dense/sparse auto switch: widths
# above this emit sparse pair columns under dense_output='auto'
DENSE_AUTO_LIMIT = 1 << 14


def _densify(idx: torch.Tensor, val: torch.Tensor, width: int
             ) -> torch.Tensor:
    """(n, W) int64 / f32 pair on one device -> (n, width) f32. Negative
    columns count from the end and columns outside [0, width) are
    dropped, as the reference's scatter does."""
    n = idx.shape[0]
    out = torch.zeros(n * width, dtype=torch.float32, device=idx.device)
    if idx.numel() == 0:
        return out.view(n, width)
    col = torch.where(idx < 0, idx + width, idx)
    keep = (col >= 0) & (col < width)
    rows = torch.arange(n, device=idx.device).unsqueeze(1).expand_as(col)
    key = (rows * width + col)[keep]
    v = val[keep]
    if key.numel() == 0:
        return out.view(n, width)
    key, order = torch.sort(key, stable=True)
    slots, counts = torch.unique_consecutive(key, return_counts=True)
    out[slots] = torch.segment_reduce(v[order], "sum", lengths=counts,
                                      unsafe=True)
    return out.view(n, width)


def to_dense(idx: np.ndarray, val: np.ndarray, width: int,
             device=None) -> np.ndarray:
    """(n, W) sparse pair -> (n, width) dense f32, summing collisions, on
    `device` (None = the card). Use only when width is small enough to
    hold."""
    dev = resolve_device(device)
    i = torch.as_tensor(np.asarray(idx, np.int32)).to(dev, torch.int64)
    v = torch.as_tensor(np.asarray(val, np.float32)).to(dev)
    return _densify(i, v, int(width)).cpu().numpy()


def rows_to_pair(rows_idx, rows_val, min_width: int = 1):
    """Ragged per-row (indices, values) lists -> padded (n, W) pair."""
    n = len(rows_idx)
    width = max(max((len(r) for r in rows_idx), default=0), min_width)
    idx = np.zeros((n, width), np.int32)
    val = np.zeros((n, width), np.float32)
    for i, (ri, rv) in enumerate(zip(rows_idx, rows_val)):
        k = len(ri)
        idx[i, :k] = ri
        val[i, :k] = rv
    return idx, val
