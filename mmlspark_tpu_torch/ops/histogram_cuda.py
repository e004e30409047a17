"""Wrappers of the CUDA histogram kernels (`csrc/histogram.cu`).

Two entry points, one `.cu`: `hist_tiled` (the scatter histogram of every
level, any m*B: one kernel tiled over nodes and features) and
`hist_planes` (the planes histogram of a fit that built a plan,
`histogram.build_hist_plan`). `cuda_hist` is the first. Each wrapper
checks its inputs, allocates the zeroed outputs, launches on PyTorch's
current stream, raises if the launch was refused, and adds one to its
count in `launches`.

`plan_tiles` is the tiled kernel's planner, pure Python: from (n, F, m,
B) and the card's shared memory and SM count it picks the tile of mt
nodes x ft features a block owns, the copies of its histograms, the
threads and the row blocks. It keeps all F features in one tile where
they fit beside the level's nodes (node and stats are then read once a
call) and splits the nodes over tiles only where they do not: of the
tilings that fit, it takes the one that reads the fewest bytes (every
tile reads every row's node; each feature tile the stats of its nodes'
rows), and the widest feature tile among equals.

`plan_planes` is the planes kernel's planner, pure Python too: the h-tiles
its level needs (HT = ceil(m * B / LO / 8)), the features a block takes
(as many as its 8 warps have items for), the feature groups and the row
blocks that fill the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .histogram import check_plan

# launches per kernel, counted where each wrapper launches (and nowhere
# else) so a run can show that its path went through the kernels
launches = {"hist_tiled": 0, "hist_planes": 0}

# The planes kernel (hist_planes_kernel): 256 threads = 8 warps a block,
# tiles of 64 rows, a ring of 3 tile stages (kPlanesThreads, kRows and
# kStages in histogram.cu). A warp takes 4 / HT items (a feature's
# 16-wide lo chunk; 1 past HT = 2); blocks of HT <= 2 are built for two
# per SM, wider ones for one.
PLANES_WARPS = 8
PLANES_ROWS = 64
PLANES_STAGES = 3

# The tiled kernel's knobs, from `chip_smoke.py --sweep` on the H100 at
# the headline's 8M x 32 x 64 bins (PERF.md): all 32 features in a
# tile beat 16 and 8 at every m (m=8: 0.539 / 1.052 / 1.830 ms at 1024
# threads); 1024 threads a block beat 512 and 256 where one block fills
# an SM (m=8: 0.539 / 0.764 / 1.300 ms); 4 copies, where they fit, beat 1
# (m=1: 0.266 against 0.348 ms; m=2: 0.349 against 0.433).
TILE_THREADS = 1024             # threads per block, a multiple of 32
TILE_COPIES = 4                 # copies of a tile's histograms, where room
MAX_THREADS_PER_SM = 2048
QUEUE_PER_THREAD = 5            # kQueue / 32 in histogram.cu
# row blocks per tile at least, where the nodes are split over tiles: a
# level's rows may crowd into a few nodes, hence a few tiles
MIN_ROW_BLOCKS = 8

_P = ctypes.c_void_p
_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("histogram")
        lib.hist_card_smem.argtypes = [ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_int)]
        lib.hist_card_smem.restype = ctypes.c_int
        lib.hist_tile_launch.argtypes = [_P] * 8 + [
            ctypes.c_longlong] + [ctypes.c_int] * 9 + [_P]
        lib.hist_tile_launch.restype = ctypes.c_int
        lib.hist_tile_occupancy.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.hist_tile_occupancy.restype = ctypes.c_int
        lib.hist_planes_launch.argtypes = [_P] * 9 + [
            ctypes.c_longlong] + [ctypes.c_int] * 7 + [_P]
        lib.hist_planes_launch.restype = ctypes.c_int
        lib.hist_planes_occupancy.argtypes = [ctypes.c_int] * 4 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        lib.hist_planes_occupancy.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _card(index: int) -> tuple[int, int, int]:
    """(opt-in shared-memory bytes per block, shared-memory bytes per SM,
    SM count) of card `index`, read once per process."""
    per_block, per_sm = ctypes.c_int(), ctypes.c_int()
    err = _library().hist_card_smem(index, ctypes.byref(per_block),
                                    ctypes.byref(per_sm))
    if err != 0 or per_block.value <= 0:
        raise RuntimeError(f"cannot read the shared memory of cuda:{index} "
                           f"(cudaError_t {err})")
    return (per_block.value, per_sm.value,
            torch.cuda.get_device_properties(index).multi_processor_count)


class PlanesPlan(NamedTuple):
    """A launch of the planes kernel: blocks of fg features (`groups`
    feature groups x `row_blocks` row blocks), each taking ht h-tiles of 8
    hi digits, in `smem` bytes of shared memory."""
    ht: int
    fg: int
    groups: int
    row_blocks: int
    smem: int


def planes_items_per_warp(ht: int) -> int:
    """Items (a feature's 16-wide lo chunk) a warp of the planes kernel
    takes at ht h-tiles: its running totals are 12 * ht f32 an item."""
    return {1: 4, 2: 2}.get(ht, 1)


def planes_smem(f: int, lo: int, fg: int) -> int:
    """Shared memory of a planes block of fg features (`planes_geometry`
    in histogram.cu): PLANES_STAGES stages of the tile's plan (fg x
    PLANES_ROWS x LO bytes), its bins rows (whole rows, from a 16-byte
    boundary) and node, grad, hess and count; then two sets of a tile's
    hi bytes and packed stats."""
    bins_stage = -(-(PLANES_ROWS * f + fg + 32) // 16) * 16
    stage = fg * PLANES_ROWS * lo + bins_stage + 16 * PLANES_ROWS
    return PLANES_STAGES * stage + 2 * (fg * PLANES_ROWS + 6 * PLANES_ROWS)


def plan_planes(n: int, f: int, n_nodes: int, n_bins: int, lo: int,
                per_block: int, per_sm: int, sms: int) -> PlanesPlan:
    """The planes kernel's launch for (n, F, m, B) with digit LO on a card
    with `per_block` / `per_sm` bytes of shared memory and `sms` SMs. A
    block takes as many features as its 8 warps have items for (all 32
    of the headline's at m <= 2, LO = 16), so node, stats and bins are
    read once a feature group; the grid holds as many blocks as fit the
    card. Raises for m * B / LO past the kernel's 32 hi digits (16 at LO =
    64) or a block that does not fit."""
    if lo not in (16, 64) or n_bins % lo:
        raise ValueError(f"the planes kernel takes LO in (16, 64) with "
                         f"LO | B, got LO={lo}, B={n_bins}")
    n_hi = n_nodes * (n_bins // lo)
    ht = -(-n_hi // 8)
    fg = min(PLANES_WARPS * planes_items_per_warp(ht) * 16 // lo,
             4 * -(-f // 4))
    if ht > 4 or fg < 4:
        raise ValueError(f"m={n_nodes}, B={n_bins}: {n_hi} hi digits of "
                         f"LO={lo}; the planes kernel takes at most "
                         f"{32 if lo == 16 else 16}")
    smem = planes_smem(f, lo, fg)
    if smem > per_block:
        raise ValueError(f"F={f} needs {smem} B of shared memory for a "
                         f"planes block; the card allows {per_block}")
    groups = -(-f // fg)
    blocks = max(1, min(2 if ht <= 2 else 1, per_sm // (smem + 1024)))
    row_blocks = max(1, min(-(-n // PLANES_ROWS), blocks * sms // groups,
                            65535))
    return PlanesPlan(ht, fg, groups, row_blocks, smem)


def planes_occupancy(plan: PlanesPlan, f: int, lo: int) -> tuple[int, int]:
    """(shared memory, blocks per SM) of the planes kernel at `plan`, as
    the built kernel and the current card give them."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    _check(_library().hist_planes_occupancy(plan.ht, f, lo, plan.fg,
                                            ctypes.byref(smem),
                                            ctypes.byref(blocks)),
           "hist_planes_occupancy")
    return smem.value, blocks.value


class TilePlan(NamedTuple):
    """A launch of the tiled kernel: blocks own mt nodes x ft features
    (node_tiles x feat_tiles tiles) with `copies` copies of their
    histograms in `smem` bytes; the grid is (tiles, row_blocks) blocks of
    `threads` threads."""
    mt: int
    ft: int
    copies: int
    threads: int
    row_blocks: int
    node_tiles: int
    feat_tiles: int
    smem: int


def tile_smem(mt: int, ft: int, n_bins: int, copies: int = 1,
              threads: int = 0) -> int:
    """Shared memory of a block: 3 statistics x copies x mt x B x ft f32,
    ft rounded up to a multiple of 32 (feature f of a (node, bin) in bank
    f % 32), and a queue of QUEUE_PER_THREAD row indices per thread."""
    return 4 * (3 * copies * mt * n_bins * 32 * -(-ft // 32)
                + QUEUE_PER_THREAD * threads)


def plan_tiles(n: int, f: int, n_nodes: int, n_bins: int, per_block: int,
               per_sm: int, sms: int, *, threads: int = TILE_THREADS,
               copies: int = TILE_COPIES, ft: int | None = None,
               mt: int | None = None) -> TilePlan:
    """The tiled kernel's launch for (n, F, m, B) on a card with
    `per_block` / `per_sm` bytes of shared memory and `sms` SMs. `ft` and
    `mt` pin the features and nodes of a tile (the sweep's knobs);
    otherwise the planner picks them (the module docstring). Copies are
    taken only where the tile leaves room for them. Raises when one
    (node, feature) histogram does not fit a block."""
    if tile_smem(1, 1, n_bins, 1, threads) > per_block:
        raise ValueError(f"B={n_bins} needs "
                         f"{tile_smem(1, 1, n_bins, 1, threads)} B of shared "
                         f"memory for one node; the card allows "
                         f"{per_block}")
    best = None
    widths = range(1, f + 1) if ft is None else [-(-f // ft)]
    for n_ft in widths:
        t_ft = -(-f // n_ft)                   # balanced feature tiles
        n_ft = -(-f // t_ft)
        fit = (per_block - tile_smem(0, 0, 0, 0, threads)) \
            // tile_smem(1, t_ft, n_bins)
        if mt is not None:
            fit = min(fit, mt)
        if fit < 1:
            continue
        n_mt = -(-n_nodes // min(fit, n_nodes))
        t_mt = -(-n_nodes // n_mt)             # balanced node tiles
        cost = n_mt * n_ft * 4 * n + n_ft * 12 * n + f * n
        key = (cost, -t_ft)
        if best is None or key < best[0]:
            best = (key, t_mt, t_ft, n_mt, n_ft)
    if best is None:
        raise ValueError(f"no tile of {ft} features fits {per_block} B at "
                         f"B={n_bins}")
    _, t_mt, t_ft, n_mt, n_ft = best
    cps = max(1, min(copies, (per_block - tile_smem(0, 0, 0, 0, threads))
                     // tile_smem(t_mt, t_ft, n_bins)))
    smem = tile_smem(t_mt, t_ft, n_bins, cps, threads)
    per_sm_blocks = max(1, min(MAX_THREADS_PER_SM // threads,
                               per_sm // (smem + 1024)))
    tiles = n_mt * n_ft
    row_blocks = per_sm_blocks * sms // tiles
    if n_mt > 1:
        row_blocks = max(row_blocks, MIN_ROW_BLOCKS)
    row_blocks = max(1, min(-(-n // threads), row_blocks, 65535))
    return TilePlan(t_mt, t_ft, cps, threads, row_blocks, n_mt, n_ft, smem)


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


def hist_tiled(bins, grad, hess, node_local, active, n_nodes: int,
               n_bins: int, count_w=None):
    """The tiled kernel, any m*B, at the planner's launch."""
    ops, outs = _prepare(bins, grad, hess, node_local, active, n_nodes,
                         n_bins, count_w)
    n, f = bins.shape
    if n >= 2 ** 31:
        raise ValueError(f"the tiled kernel takes fewer than 2^31 rows, got "
                         f"{n}")
    _launch_tiled(ops, outs, n, f, n_nodes, n_bins,
                  plan_tiles(n, f, n_nodes, n_bins,
                             *_card(bins.device.index or 0)))
    return tuple(outs)


def tile_occupancy(plan: TilePlan, with_count: bool) -> int:
    """Blocks of the tiled kernel at `plan` (with or without a count
    operand) that fit one SM of the current card."""
    blocks = ctypes.c_int()
    _check(_library().hist_tile_occupancy(int(with_count), plan.threads,
                                          plan.smem, ctypes.byref(blocks)),
           "hist_tile_occupancy")
    return blocks.value


def _launch_tiled(ops, outs, n, f, n_nodes, n_bins, plan: TilePlan):
    """Launch `hist_tile_kernel` at a given plan and count it."""
    vec = f % 16 == 0 and plan.ft % 16 == 0 and ops[0].data_ptr() % 16 == 0
    with torch.cuda.device(outs[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_library().hist_tile_launch(
            *_ptrs(ops, outs), n, f, n_nodes, n_bins, plan.mt, plan.ft,
            plan.copies, plan.threads, plan.row_blocks, int(vec), stream),
            "hist_tiled")
    launches["hist_tiled"] += 1


def _aligned(t):
    """t, or a copy of it, at a 16-byte aligned address (cp.async)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def hist_planes(bins, grad, hess, node_local, active, n_nodes: int,
                n_bins: int, count_w=None, lo_planes=None, plane_lo: int = 0):
    """Planes kernel: the histograms from the fit's (F, n, LO) int8 plan,
    with grad/hess/count rounded to bf16 (`histogram._torch_hist_planes`
    is its plain version), at `plan_planes`' launch. Raises when the plan
    does not fit these bins or the level is past the kernel's hi digits."""
    if lo_planes is None:
        raise ValueError("hist_planes needs the fit's plan (lo_planes)")
    ops, outs = _prepare(bins, grad, hess, node_local, active, n_nodes,
                         n_bins, count_w)
    check_plan(bins, lo_planes, plane_lo, n_bins)
    plan = lo_planes.contiguous()
    if plan.data_ptr() % 16:
        raise ValueError("the plan must be 16-byte aligned (cp.async of "
                         "16-byte chunks)")
    ops = [_aligned(t) for t in ops]
    n, f = bins.shape
    geo = plan_planes(n, f, n_nodes, n_bins, plane_lo,
                      *_card(bins.device.index or 0))
    with torch.cuda.device(bins.device):
        stream = torch.cuda.current_stream().cuda_stream
        _check(_library().hist_planes_launch(
            plan.data_ptr(), *_ptrs(ops, outs), n, f, n_nodes, n_bins,
            plane_lo, geo.ht, geo.fg, geo.row_blocks, stream), "hist_planes")
    launches["hist_planes"] += 1
    return tuple(outs)


def cuda_hist(bins, grad, hess, node_local, active, n_nodes: int,
              n_bins: int, count_w=None):
    """The CUDA path of `node_feature_histograms`: the tiled kernel, at
    every m*B."""
    return hist_tiled(bins, grad, hess, node_local, active, n_nodes, n_bins,
                      count_w=count_w)
