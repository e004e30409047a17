"""The GBDT hot op: per-(node, feature, bin) gradient/hessian/count histograms.

Port of `mmlspark_tpu/ops/histogram.py` and of the precomputed-planes
router and plan of `mmlspark_tpu/ops/histogram_pallas.py`. The contract of
`node_feature_histograms` is the reference's: (n, F) uint8 bins plus
per-row grad/hess/node_local/active/count_w in, three (m, F, B) f32
histograms out. Inactive rows drop out; the count histogram sums the
`count_w` presence indicator (1 = the row is present this iteration), not
hess, because user sample weights must not change data counts.

Two functions, each with a plain version here and a CUDA kernel in
`histogram_cuda.py`:

- the scatter histogram (`_torch_hist`, one `index_add_` per statistic
  into per-row-block partial histograms that are then added, mirroring
  the reference's `_xla_hist`; kernel `hist_tiled`), f32 throughout;
- the planes histogram (`_torch_hist_planes`; kernel `hist_planes`),
  taken when the fit built a plan (`build_hist_plan`, under
  `MMLSPARK_TPU_HIST=planes`) and the level has m <= `PLANES_M_MAX`
  nodes: the joint key node*B + bin is split into hi = key // LO and
  lo = key % LO = bin % LO, the lo one-hot is read from the per-fit plan,
  and grad/hess are rounded to bf16 before the product, as the TPU
  kernel does (`histogram_pallas.py:24-29`).

The tensor's device chooses the implementation: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises. Nothing falls
back.
"""
from __future__ import annotations

import torch

# levels with more nodes than this take the scatter kernels even when the
# fit built a plan (the reference's `histogram_pallas.PLANES_M_MAX`)
PLANES_M_MAX = 4

# `_torch_hist` sums rows in contiguous blocks of at least this many rows
# (one block up to it), at most _PLAIN_BLOCKS of them, with at most
# _PLAIN_CELLS partial-histogram cells in all
_PLAIN_BLOCK_ROWS = 1 << 14
_PLAIN_BLOCKS = 1024
_PLAIN_CELLS = 1 << 25


def plan_lo_bins(n_bins: int) -> int:
    """Width LO of the plan's lo digit for `n_bins` bins (0 = no plan).
    LO must divide B, so that (node*B + bin) % LO == bin % LO does not
    change with the level: LO = 64 for B >= 128 with 64 | B, LO = 16 for
    64 <= B < 128 with 16 | B, as the reference's `plan_lo_bins`."""
    if n_bins >= 128:
        return 64 if n_bins % 64 == 0 else 0
    if n_bins >= 64 and n_bins % 16 == 0:
        return 16
    return 0


def planes_route(n_nodes: int, n_bins: int, has_planes: bool) -> int:
    """LO when a level of `n_nodes` nodes over `n_bins` bins takes the
    planes histogram, else 0: the planes branch of the reference's
    `kernel_route`. The reference's `MMLSPARK_TPU_HIST_JOINT64=0` turns
    off its LO=16 routes because of a Mosaic lane-width limit; Hopper has
    no such limit, so the port does not read that variable."""
    if has_planes and n_nodes <= PLANES_M_MAX:
        return plan_lo_bins(n_bins)
    return 0


def build_hist_plan(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """The per-fit plan: an (F, n, LO) int8 one-hot of bin % LO, built
    once per fit (bins never change across levels, trees or iterations).
    Row-major per feature, so one (row, feature) reads its LO bytes as
    LO/16 16-byte loads. F*n*LO bytes: 4.1 GB at 8M x 32 with LO = 16.
    Raises when no LO divides `n_bins` (`plan_lo_bins` == 0)."""
    lo = plan_lo_bins(n_bins)
    if not lo:
        raise ValueError(f"no plane digit divides n_bins={n_bins}; the "
                         f"planes route needs LO | B (plan_lo_bins)")
    n, f = bins.shape
    digits = torch.arange(lo, dtype=torch.uint8, device=bins.device)
    plan = torch.empty((f, n, lo), dtype=torch.int8, device=bins.device)
    for j in range(f):      # one feature at a time: n*LO bytes of scratch
        plan[j] = bins[:, j, None] % lo == digits
    return plan


def check_plan(bins, lo_planes, plane_lo: int, n_bins: int) -> None:
    """Raise unless `lo_planes` is an int8 plan of these bins' shape at
    the digit width `n_bins` calls for."""
    n, f = bins.shape
    want = plan_lo_bins(n_bins)
    if not want or plane_lo != want:
        raise ValueError(f"planes route at B={n_bins} needs a plan with "
                         f"LO={want} (got plane_lo={plane_lo})")
    if (lo_planes.dtype != torch.int8
            or tuple(lo_planes.shape) != (f, n, plane_lo)
            or lo_planes.device != bins.device):
        raise ValueError(
            f"hist plan {lo_planes.dtype} {tuple(lo_planes.shape)} on "
            f"{lo_planes.device} does not match this call's int8 "
            f"({f}, {n}, {plane_lo}) on {bins.device}: the plan must be "
            f"built from the SAME bins matrix (build_hist_plan)")


def _torch_hist(bins, grad, hess, node_local, active, n_nodes: int,
                n_bins: int, count_w=None):
    """Plain version: one `index_add_` per statistic over the key
    ((node * F) + f) * B + bin. Inactive rows go to one extra slot that is
    sliced off (the reference drops them as out-of-range scatter ids).

    Past `_PLAIN_BLOCK_ROWS` rows, rows are added in contiguous row
    blocks, each into its own partial histogram, and the partials are
    then summed, as the kernel sums per block before its flush. One f32 cell that takes
    millions of rows one at a time drifts: on an H100 at 8M rows with a
    category holding half of them, a single index_add_ was off by 6e-3 of
    sum |grad| (`chip_smoke.py` [categorical] prints it)."""
    n, f = bins.shape
    dev = bins.device
    num_segments = n_nodes * f * n_bins
    blocks = max(1, min(-(-n // _PLAIN_BLOCK_ROWS), _PLAIN_BLOCKS,
                        _PLAIN_CELLS // (num_segments + 1)))
    feat_ids = torch.arange(f, dtype=torch.int64, device=dev)[None, :]
    keys = ((node_local.to(torch.int64)[:, None] * f + feat_ids) * n_bins
            + bins.to(torch.int64))
    keys = torch.where(active[:, None], keys,
                       torch.full_like(keys, num_segments))
    block = torch.arange(n, dtype=torch.int64, device=dev) * blocks // n
    keys += (block * (num_segments + 1))[:, None]
    keys = keys.reshape(-1)

    def seg(vals):
        out = torch.zeros((blocks, num_segments + 1), dtype=torch.float32,
                          device=dev)
        out.view(-1).index_add_(0, keys, vals.to(torch.float32)[:, None]
                                .expand(n, f).reshape(-1))
        return out[:, :num_segments].sum(0).reshape(n_nodes, f, n_bins)

    cnt = (torch.ones_like(hess, dtype=torch.float32) if count_w is None
           else count_w.to(torch.float32))
    return seg(grad), seg(hess), seg(cnt)


def _torch_hist_planes(bins, grad, hess, node_local, active, n_nodes: int,
                       n_bins: int, count_w=None, lo_planes=None,
                       plane_lo: int = 0):
    """Plain version of the planes histogram, one feature at a time: the
    (n, m*W) one-hot of hi = node*W + bin // LO (W = B / LO), scaled by
    the bf16-rounded (grad, hess, count) columns, times the feature's
    (n, LO) plan in f32; the (3, m*W, LO) product is the (3, m, B)
    histogram. Rows that are inactive, outside [0, m) or with a bin >= B
    add nothing."""
    check_plan(bins, lo_planes, plane_lo, n_bins)
    n, f = bins.shape
    lo, dev = plane_lo, bins.device
    w = n_bins // lo
    n_hi = n_nodes * w
    cnt = (torch.ones_like(hess, dtype=torch.float32) if count_w is None
           else count_w.to(torch.float32))
    stats = torch.stack([grad.to(torch.float32), hess.to(torch.float32),
                         cnt], 1).to(torch.bfloat16).to(torch.float32)
    node = node_local.to(torch.int64)
    valid = active & (node >= 0) & (node < n_nodes)
    hi_ids = torch.arange(n_hi, device=dev)
    out = torch.empty((3, n_nodes, f, n_bins), dtype=torch.float32,
                      device=dev)
    for j in range(f):
        b = bins[:, j].to(torch.int64)
        hi = torch.where(valid & (b < n_bins), node * w + b // lo, -1)
        onehot = (hi[:, None] == hi_ids).to(torch.float32)     # (n, m*W)
        u = (stats[:, :, None] * onehot[:, None, :]).reshape(n, 3 * n_hi)
        res = u.T @ lo_planes[j].to(torch.float32)             # (3*m*W, LO)
        out[:, :, j] = res.reshape(3, n_nodes, n_bins)
    return out[0], out[1], out[2]


def node_feature_histograms(bins, grad, hess, node_local, active,
                            n_nodes: int, n_bins: int, count_w=None,
                            lo_planes=None, plane_lo: int = 0):
    """(n, F) uint8 bins + per-row grad/hess -> three (n_nodes, F, n_bins)
    f32 histograms. Rows with active=False contribute nothing; rows with
    count_w=0 contribute to no count (see `_torch_hist`).

    `lo_planes`/`plane_lo`: the fit's plan (`build_hist_plan`); with one,
    levels of at most `PLANES_M_MAX` nodes take the planes histogram."""
    planes = planes_route(n_nodes, n_bins, lo_planes is not None)
    if bins.device.type == "cpu":
        if planes:
            return _torch_hist_planes(bins, grad, hess, node_local, active,
                                      n_nodes, n_bins, count_w=count_w,
                                      lo_planes=lo_planes, plane_lo=plane_lo)
        return _torch_hist(bins, grad, hess, node_local, active, n_nodes,
                           n_bins, count_w=count_w)
    if bins.device.type != "cuda":
        raise ValueError(f"no histogram path for device {bins.device}")
    from . import histogram_cuda
    if planes:
        return histogram_cuda.hist_planes(
            bins, grad, hess, node_local, active, n_nodes, n_bins,
            count_w=count_w, lo_planes=lo_planes, plane_lo=plane_lo)
    return histogram_cuda.cuda_hist(bins, grad, hess, node_local, active,
                                    n_nodes, n_bins, count_w=count_w)
