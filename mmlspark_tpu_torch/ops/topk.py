"""Top-k along rows with the reference's tie order.

The reference's `lax.top_k` returns the k largest values of each row in
descending order, the lower index first among equal values.
`torch.topk` promises no order among ties, on the CPU or the card, and
SAR's jaccard scores and KNN's integer-valued products tie often. `top_k`
makes the port's answer the reference's on both devices, so a reply does
not change from run to run: the k-th largest value of each row decides
the set (every value above it, then the lowest indices among the values
equal to it), and a stable sort on (-value, index) orders it. Plain
torch ops; no kernel.
"""
from __future__ import annotations

import torch


def top_k(scores: torch.Tensor, k: int) -> tuple:
    """(values, indices) of the k largest entries of each row of the 2-D
    `scores`, descending, the lower index first among equal values (the
    reference's `lax.top_k`). NaN is not supported."""
    n, m = scores.shape
    k = min(int(k), m)
    if n == 0 or k == 0:
        return (scores.new_empty((n, k)),
                torch.empty((n, k), dtype=torch.int64, device=scores.device))
    vals, idx = torch.topk(scores, k, dim=1)
    kth = vals.min(dim=1, keepdim=True).values
    # rows whose k-th value ties with values left out: the set itself
    # depends on the tie order there
    crossing = (scores >= kth).sum(dim=1) > k
    rows = crossing.nonzero().flatten()
    if rows.numel():
        sub = scores.index_select(0, rows)
        sub_kth = kth.index_select(0, rows)
        above = sub > sub_kth
        equal = sub == sub_kth
        need = k - above.sum(dim=1, keepdim=True, dtype=torch.int32)
        rank = equal.to(torch.int32).cumsum(dim=1, dtype=torch.int32)
        take = above | (equal & (rank <= need))
        # nonzero lists each row's k columns in ascending order
        cols = take.nonzero()[:, 1].reshape(rows.numel(), k)
        idx = idx.index_copy(0, rows, cols)
    idx = idx.sort(dim=1).values
    vals = scores.gather(1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)
