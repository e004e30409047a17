"""Wrappers of the CUDA histogram kernels (`csrc/histogram.cu`).

Three entry points, one `.cu`: `hist_smem` (per-block shared-memory
histograms, the main path), `hist_global` (global atomics, for an m*B
too large for one block's shared memory) and `hist_planes` (the planes
histogram of a fit that built a plan, `histogram.build_hist_plan`).
`cuda_hist` picks between the first two by that size alone. Each wrapper
checks its inputs, allocates the zeroed outputs, launches on PyTorch's
current stream, raises if the launch was refused, and adds one to its
count in `launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .histogram import check_plan

# launches per kernel, counted where each wrapper launches (and nowhere
# else) so a run can show that its path went through the kernels
launches = {"hist_smem": 0, "hist_global": 0, "hist_planes": 0}

# Launch geometry of hist_smem, from `chip_smoke.py --sweep` on the H100
# at 8M x 32 x 64 bins (PERF.md): a block takes as many features as fit
# 12 KB (fg = 16, 8, 4, 2 at m = 1, 2, 4, 8), the fastest feature group
# at every m measured; the grid holds 8 blocks per SM in all, where the
# time stops falling (16 and 32 are within 1%).
SMEM_TARGET_BYTES = 12 * 1024
THREADS = 256                   # kThreads in histogram.cu
BLOCKS_PER_SM = 8

_P = ctypes.c_void_p
_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("histogram")
        lib.hist_smem_limit.argtypes = [ctypes.c_int]
        lib.hist_smem_limit.restype = ctypes.c_int
        lib.hist_smem_launch.argtypes = [_P] * 8 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _P]
        lib.hist_smem_launch.restype = ctypes.c_int
        lib.hist_global_launch.argtypes = [_P] * 8 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _P]
        lib.hist_global_launch.restype = ctypes.c_int
        lib.hist_planes_launch.argtypes = [_P] * 9 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
        lib.hist_planes_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def smem_bytes_per_feature(n_nodes: int, n_bins: int) -> int:
    return 3 * n_nodes * n_bins * 4


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple[int, int]:
    """(opt-in shared-memory bytes per block, SM count) of card `index`,
    read once per process."""
    limit = int(_library().hist_smem_limit(index))
    if limit <= 0:
        raise RuntimeError(f"cannot read the shared-memory limit of cuda:"
                           f"{index}")
    return limit, torch.cuda.get_device_properties(index).multi_processor_count


def smem_limit(device: torch.device) -> int:
    return _card(device.index or 0)[0]


def smem_geometry(n: int, f: int, n_nodes: int, n_bins: int,
                  device: torch.device) -> tuple[int, int]:
    """(features per block, row blocks per feature group) of a
    `hist_smem` or `hist_planes` launch. Raises when one feature's
    3*m*B f32 does not fit a block."""
    per_feat = smem_bytes_per_feature(n_nodes, n_bins)
    if per_feat > smem_limit(device):
        raise ValueError(f"m={n_nodes}, B={n_bins} needs {per_feat} B of "
                         f"shared memory per feature; the card allows "
                         f"{smem_limit(device)} (use hist_global)")
    sms = _card(device.index or 0)[1]
    fg = max(1, min(SMEM_TARGET_BYTES // per_feat, f))
    groups = -(-f // fg)
    row_blocks = max(1, min(-(-n // THREADS), BLOCKS_PER_SM * sms // groups,
                            65535))
    return fg, row_blocks


def _prepare(bins, grad, hess, node_local, active, n_nodes, n_bins,
             count_w):
    """Check the inputs and return the kernel's operands and outputs."""
    if bins.device.type != "cuda":
        raise ValueError(f"CUDA histogram kernel got a {bins.device} tensor")
    if bins.dtype != torch.uint8 or bins.dim() != 2:
        raise ValueError(f"bins must be (n, F) uint8, got {bins.dtype} "
                         f"{tuple(bins.shape)}")
    n, f = bins.shape
    for name, t in (("grad", grad), ("hess", hess),
                    ("node_local", node_local), ("active", active)):
        if t.shape != (n,) or t.device != bins.device:
            raise ValueError(f"{name} must be ({n},) on {bins.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if not 1 <= n_bins <= 256:
        raise ValueError(f"n_bins must be in [1, 256], got {n_bins}")
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    node = torch.where(active, node_local, -1).to(torch.int32).contiguous()
    ops = [bins.contiguous(), node,
           grad.to(torch.float32).contiguous(),
           hess.to(torch.float32).contiguous()]
    if count_w is not None:
        if count_w.shape != (n,) or count_w.device != bins.device:
            raise ValueError(f"count_w must be ({n},) on {bins.device}")
        ops.append(count_w.to(torch.float32).contiguous())
    else:
        ops.append(None)
    outs = [torch.zeros((n_nodes, f, n_bins), dtype=torch.float32,
                        device=bins.device) for _ in range(3)]
    return ops, outs


def _ptrs(ops, outs):
    return [None if t is None else t.data_ptr() for t in ops] + \
        [t.data_ptr() for t in outs]


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def hist_smem(bins, grad, hess, node_local, active, n_nodes: int,
              n_bins: int, count_w=None):
    """Shared-memory kernel. A block takes as many features as fit
    `SMEM_TARGET_BYTES` (at least one, which may use the card's opt-in
    limit; `smem_geometry` raises when one does not fit)."""
    ops, outs = _prepare(bins, grad, hess, node_local, active, n_nodes,
                         n_bins, count_w)
    n, f = bins.shape
    _launch_smem(ops, outs, n, f, n_nodes, n_bins,
                 *smem_geometry(n, f, n_nodes, n_bins, bins.device))
    return tuple(outs)


def _launch_smem(ops, outs, n, f, n_nodes, n_bins, fg, row_blocks):
    """Launch `hist_smem_kernel` at a given geometry and count it."""
    with torch.cuda.device(outs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_library().hist_smem_launch(*_ptrs(ops, outs), n, f,
                                           n_nodes, n_bins, fg, row_blocks,
                                           stream), "hist_smem")
    launches["hist_smem"] += 1


def hist_global(bins, grad, hess, node_local, active, n_nodes: int,
                n_bins: int, count_w=None):
    """Global-atomics kernel: any m*B."""
    ops, outs = _prepare(bins, grad, hess, node_local, active, n_nodes,
                         n_bins, count_w)
    n, f = bins.shape
    sms = _card(bins.device.index or 0)[1]
    blocks = max(1, min(-(-n // THREADS), BLOCKS_PER_SM * sms))
    with torch.cuda.device(bins.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_library().hist_global_launch(*_ptrs(ops, outs), n, f,
                                             n_nodes, n_bins, blocks,
                                             stream), "hist_global")
    launches["hist_global"] += 1
    return tuple(outs)


def hist_planes(bins, grad, hess, node_local, active, n_nodes: int,
                n_bins: int, count_w=None, lo_planes=None, plane_lo: int = 0):
    """Planes kernel: the histograms from the fit's (F, n, LO) int8 plan,
    with grad/hess/count rounded to bf16 (`histogram._torch_hist_planes`
    is its plain version). Launch geometry as `hist_smem`'s. Raises when
    the plan does not fit these bins or one feature's 3*m*B f32 does not
    fit a block."""
    if lo_planes is None:
        raise ValueError("hist_planes needs the fit's plan (lo_planes)")
    ops, outs = _prepare(bins, grad, hess, node_local, active, n_nodes,
                         n_bins, count_w)
    check_plan(bins, lo_planes, plane_lo, n_bins)
    plan = lo_planes.contiguous()
    if plan.data_ptr() % 16:
        raise ValueError("the plan must be 16-byte aligned (one vector "
                         "load per 16 plan bytes)")
    n, f = bins.shape
    fg, row_blocks = smem_geometry(n, f, n_nodes, n_bins, bins.device)
    with torch.cuda.device(bins.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_library().hist_planes_launch(
            plan.data_ptr(), *_ptrs(ops, outs), n, f, n_nodes, n_bins,
            plane_lo, fg, row_blocks, stream), "hist_planes")
    launches["hist_planes"] += 1
    return tuple(outs)


def cuda_hist(bins, grad, hess, node_local, active, n_nodes: int,
              n_bins: int, count_w=None):
    """The CUDA path of `node_feature_histograms`: shared-memory kernel
    when one feature's histogram fits a block, else global atomics."""
    if smem_bytes_per_feature(n_nodes, n_bins) <= smem_limit(bins.device):
        return hist_smem(bins, grad, hess, node_local, active, n_nodes,
                         n_bins, count_w=count_w)
    return hist_global(bins, grad, hess, node_local, active, n_nodes,
                       n_bins, count_w=count_w)
