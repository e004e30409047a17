"""The GBDT hot op: per-(node, feature, bin) gradient/hessian/count histograms.

Port of `mmlspark_tpu/ops/histogram.py`. The contract of
`node_feature_histograms` is the reference's: (n, F) uint8 bins plus
per-row grad/hess/node_local/active/count_w in, three (m, F, B) f32
histograms out. Inactive rows drop out; the count histogram sums the
`count_w` presence indicator (1 = the row is present this iteration), not
hess, because user sample weights must not change data counts.

The tensor's device chooses the path: a CPU tensor takes `_torch_hist`,
the plain version (one `index_add_` per statistic, mirroring the
reference's `_xla_hist`); a CUDA tensor launches the hand-written kernel
in `histogram_cuda.py` or raises. Nothing falls back.
"""
from __future__ import annotations

import torch


def _torch_hist(bins, grad, hess, node_local, active, n_nodes: int,
                n_bins: int, count_w=None):
    """Plain version: one `index_add_` per statistic over the key
    ((node * F) + f) * B + bin. Inactive rows go to one extra slot that is
    sliced off (the reference drops them as out-of-range scatter ids)."""
    n, f = bins.shape
    dev = bins.device
    num_segments = n_nodes * f * n_bins
    feat_ids = torch.arange(f, dtype=torch.int64, device=dev)[None, :]
    keys = ((node_local.to(torch.int64)[:, None] * f + feat_ids) * n_bins
            + bins.to(torch.int64))
    keys = torch.where(active[:, None], keys,
                       torch.full_like(keys, num_segments)).reshape(-1)

    def seg(vals):
        out = torch.zeros(num_segments + 1, dtype=torch.float32, device=dev)
        out.index_add_(0, keys, vals.to(torch.float32)[:, None]
                       .expand(n, f).reshape(-1))
        return out[:num_segments].reshape(n_nodes, f, n_bins)

    cnt = (torch.ones_like(hess, dtype=torch.float32) if count_w is None
           else count_w.to(torch.float32))
    return seg(grad), seg(hess), seg(cnt)


def node_feature_histograms(bins, grad, hess, node_local, active,
                            n_nodes: int, n_bins: int, count_w=None):
    """(n, F) uint8 bins + per-row grad/hess -> three (n_nodes, F, n_bins)
    f32 histograms. Rows with active=False contribute nothing; rows with
    count_w=0 contribute to no count (see `_torch_hist`)."""
    if bins.device.type == "cpu":
        return _torch_hist(bins, grad, hess, node_local, active, n_nodes,
                           n_bins, count_w=count_w)
    if bins.device.type != "cuda":
        raise ValueError(f"no histogram path for device {bins.device}")
    from .histogram_cuda import cuda_hist
    return cuda_hist(bins, grad, hess, node_local, active, n_nodes, n_bins,
                     count_w=count_w)
