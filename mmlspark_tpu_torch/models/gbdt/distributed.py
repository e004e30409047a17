"""Data-parallel and voting-parallel GBDT over the port's mesh.

Port of `mmlspark_tpu/models/gbdt/distributed.py`. The reference runs a
`shard_map` over the mesh's data axis whose tree grower sums each level's
histograms with a `lax.psum`. The port runs the same form on its own
mesh (`parallel/mesh.py`, an ndarray of `torch.device`s): rows are split
over the data axis's positions, each position builds its histograms with
the same kernel a one-position fit launches, the histograms are added
over the positions in position order, and one split search on the sums
decides for every position (`trainer.train_one_tree_sharded`). The data
axis may span processes (`parallel.cluster`): each process then holds
its positions' rows, the sums gather every process's positions and add
them in global position order on every process, and every process grows
the same trees, with nothing to gather afterwards. Both of the
reference's tree learners:

- data_parallel: every level's histograms summed (siblings by
  subtraction of the sums);
- voting_parallel (PV-tree): each position votes its local top-k
  features per node, the top 2k by tally are elected, and only their
  histograms are summed (`trainer._voting_feature_mask`).

Ragged row counts are padded to a multiple of the positions with weight
0 and presence 0, so padding adds nothing to a histogram, a leaf or the
init score, and never counts toward min_data_in_leaf, while a user's zero
weights still count. Positions may share a device
(`data_mesh(devices=[cuda:0] * 4)`): moving a tensor between two of them
is then no copy.

Not ported: the reference's `AotCache` compile records of the tree
grower and its semantic contracts (`distributed.py:51-79`, `:210-297`),
which are ROADMAP Queue 1 items 23 and 24.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...device import resolve_device
from ...ops import binning
from ...parallel import cluster
from ...parallel.mesh import DATA_AXIS, data_mesh, pad_to_multiple
from . import objectives as obj_mod
from . import trainer
from .boosting import fit_booster


def default_mesh(num_tasks: int = 0, device=None):
    """The data mesh a fit with `num_tasks` workers shards over: that many
    positions (every visible card for 0) of the card, or of `device` when
    it is not a card (`device="cpu"`: num_tasks CPU positions)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return data_mesh(num_tasks if num_tasks > 1 else None)
    n = max(int(num_tasks), 1)
    return data_mesh(n, devices=[dev] * n)


def make_sharded_tree_fn(mesh, parallelism: str = "data_parallel",
                         top_k: int = 20):
    """`trainer.train_one_tree_sharded` over `mesh`'s data axis: rows in
    (one tensor per position, `shard_rows`), the tree on the first
    position's device and each position's deltas out."""
    if parallelism not in ("data_parallel", "voting_parallel"):
        raise ValueError(f"unknown parallelism {parallelism!r}")
    voting = top_k if parallelism == "voting_parallel" else None
    n_pos = mesh.shape[DATA_AXIS]

    n_local = mesh.local_positions
    exchange = mesh.exchange if mesh.process_count > 1 else None

    def tree_fn(bins, grad, hess, fmask, cfg, count_w=None, lo_planes=None,
                plane_lo: int = 0, fixed_order: bool = False):
        if len(bins) != n_local:
            raise ValueError(f"{len(bins)} row shards for this process's "
                             f"{n_local} of a data axis of {n_pos} "
                             f"positions")
        return trainer.train_one_tree_sharded(
            bins, grad, hess, fmask, cfg, count_w=count_w,
            lo_planes=lo_planes, plane_lo=plane_lo, fixed_order=fixed_order,
            voting_top_k=voting, exchange=exchange)

    return tree_fn


def fit_booster_distributed(x, y, params, weights=None, init_scores=None,
                            group=None, valid=None, init_booster=None,
                            callbacks=None,
                            parallelism: str = "data_parallel",
                            top_k: int = 20, num_tasks: int = 0,
                            checkpoint_fn=None,
                            checkpoint_interval: int = 25,
                            init_base: float = 0.0, ingest=None,
                            oocore=None, init_margin=None,
                            init_rng_key=None, iter_offset: int = 0,
                            mesh=None, device=None, prebinned=None,
                            local_rows: bool = False):
    """`fit_booster` with the rows split over the data axis of `mesh`
    (None: `default_mesh(num_tasks, device)`). Returns (booster, base,
    eval_history) as `fit_booster`; the trees are built once from the
    summed histograms, so there is nothing to gather.

    `prebinned=(mapper, bins[, y])` (the port's own, as `fit_booster`'s):
    bins already binned, padded here. A checkpoint's `init_margin` is the
    padded fit's margin, and resumes the fit on the same rows and mesh
    size. `ingest` and `oocore` pass through to `fit_booster` (`x` may
    then be an .npy path).

    Over a mesh that spans processes, two forms. By default every process
    passes the whole table (the reference's semantics; `x` may be an .npy
    path, memory-mapped, and `prebinned` may hold the whole memory-mapped
    bins) and keeps its positions' rows of it: the bins come from the same
    `fit_bins` on every process, the boost-from-average score from the
    whole `y`, and `valid` is split by `cluster.process_row_range`, so a
    fixed-order fit equals the one-process fit over the same positions
    bit for bit. With `local_rows=True` (the scale-out form) `x`, `y`,
    `weights`, `init_scores`, `group`, `valid` and `prebinned=(mapper,
    bins, y)` hold only this process's rows (`process_row_range`): the
    mapper is the caller's (`broadcast_from_leader` of process 0's), or
    process 0's `fit_bins` of its rows, and the init score comes from
    float64 partial sums added in process order. That form gives the same
    booster on every process and the whole-table fit's split features
    with margins within ROADMAP Queue 3 (e)'s tolerances, not its bits.
    `init_margin` is then this process's margin."""
    if parallelism not in ("data_parallel", "voting_parallel"):
        raise ValueError(f"unknown parallelism {parallelism!r}")
    if mesh is None:
        mesh = default_mesh(num_tasks, device)
    common = dict(
        init_booster=init_booster, callbacks=callbacks,
        checkpoint_fn=checkpoint_fn, checkpoint_interval=checkpoint_interval,
        init_base=init_base, init_margin=init_margin,
        init_rng_key=init_rng_key, iter_offset=iter_offset, mesh=mesh,
        voting_top_k=top_k if parallelism == "voting_parallel" else None)
    if mesh.process_count > 1:
        return _fit_processes(x, y, params, weights, init_scores, group,
                              valid, ingest, oocore, prebinned, local_rows,
                              mesh, common)
    nsh = mesh.shape[DATA_AXIS]
    if isinstance(x, str):
        # out-of-core source: memory-map here; the f32 asarray below is a
        # view when rows already divide the mesh, so the raw matrix never
        # materializes and `oocore`'s stager streams its binning
        x = np.load(x, mmap_mode="r")
    n = x.shape[0]
    ragged = n % nsh != 0
    x_p, _ = pad_to_multiple(np.asarray(x, np.float32), nsh)
    y_p, _ = pad_to_multiple(np.asarray(y, np.float32), nsh)
    w_p = pres_p = None
    if weights is not None or ragged:
        # padding rows get weight 0
        w = (np.ones(n, np.float32) if weights is None
             else np.asarray(weights, np.float32))
        w_p, _ = pad_to_multiple(w, nsh)
    if ragged:
        # the presence channel: padding never counts toward
        # min_data_in_leaf, while a user's zero weights do (LightGBM)
        pres_p, _ = pad_to_multiple(np.ones(n, np.float32), nsh)
    init_p = None
    if init_scores is not None:
        init_p, _ = pad_to_multiple(np.asarray(init_scores, np.float32),
                                    nsh)
    group_p = None
    if group is not None:
        # padding rows get a fresh group id, so they pair with nothing
        group = np.asarray(group, np.int32)
        group_p, _ = pad_to_multiple(group, nsh, fill=int(group.max()) + 1)
    if prebinned is not None:
        first = mesh.axis_devices(DATA_AXIS)[0]
        mapper, bins = prebinned[0], torch.as_tensor(prebinned[1]).to(first)
        staged = [pad_to_multiple(bins, nsh)[0]]
        if len(prebinned) == 3:
            staged.append(pad_to_multiple(
                torch.as_tensor(prebinned[2]).to(first), nsh)[0])
        prebinned = (mapper, *staged)
    return fit_booster(
        x_p, y_p, params, weights=w_p, init_scores=init_p, valid=valid,
        prebinned=prebinned, group=group_p, ingest=ingest, oocore=oocore,
        presence=pres_p, **common)


def _pad_rows(a, block: int, fill=0):
    """`a` (numpy or tensor) padded at its end to `block` rows."""
    if a is None or a.shape[0] == block:
        return a
    if torch.is_tensor(a):
        return torch.cat([a, torch.full((block - a.shape[0],) + a.shape[1:],
                                        fill, dtype=a.dtype,
                                        device=a.device)])
    a = np.asarray(a)
    width = [(0, block - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, width, constant_values=fill)


def _tensor(a) -> torch.Tensor:
    """A tensor as it is; an array (a memory-mapped slice too) copied into
    a host tensor."""
    return a if torch.is_tensor(a) else torch.from_numpy(np.array(a))


def _fit_processes(x, y, params, weights, init_scores, group, valid,
                   ingest, oocore, prebinned, local_rows: bool, mesh,
                   common):
    """`fit_booster_distributed` over a data axis that spans processes:
    this process's block of rows, padded to the block every process
    holds (weight 0, presence 0), binned by one mapper (the docstring's
    two forms)."""
    n_proc, pid = mesh.process_count, mesh.process_index
    n_loc_pos = mesh.local_positions
    first = mesh.axis_devices(DATA_AXIS)[0]
    if isinstance(x, str):
        x = np.load(x, mmap_mode="r")
    base_score = None       # the scale-out form: partial sums (fit_booster)
    p = params
    if local_rows:
        # the scale-out form: every process pads to the largest share
        counts = cluster.all_gather_object(int(x.shape[0]))
        block = -(-max(counts) // n_loc_pos) * n_loc_pos
        lo, hi = 0, x.shape[0]
        ragged = any(c != block for c in counts)
        y_w, w_w, g_w, i_w = y, weights, group, init_scores
        v_loc = valid
    else:
        n = x.shape[0]
        nsh = mesh.shape[DATA_AXIS]
        n_pad = -(-n // nsh) * nsh
        block = n_pad // n_proc
        lo, hi = min(pid * block, n), min((pid + 1) * block, n)
        ragged = n_pad != n
        # the whole table's padded label and weights: the init score is
        # the one-process fit's, from the same arrays
        y_w = _pad_rows(np.asarray(y, np.float32), n_pad)
        w_w = None
        if weights is not None or ragged:
            w = (np.ones(n, np.float32) if weights is None
                 else np.asarray(weights, np.float32))
            w_w = _pad_rows(w, n_pad)
        # fit_booster takes it where it boosts from the average
        base_score = obj_mod.init_score(p.objective, y_w, weights=w_w)
        g_w = None
        if group is not None:
            group = np.asarray(group, np.int32)
            g_w = _pad_rows(group, n_pad, fill=int(group.max()) + 1)
        i_w = (None if init_scores is None else
               _pad_rows(np.asarray(init_scores, np.float32), n_pad))
        y_w, w_w, g_w, i_w = (None if a is None else a[pid * block:
                                                        (pid + 1) * block]
                              for a in (y_w, w_w, g_w, i_w))
        v_loc = valid
        if valid is not None:
            v_lo, v_hi = cluster.process_row_range(len(valid[1]), pid,
                                                   n_proc)
            v_loc = (np.asarray(valid[0])[v_lo:v_hi],
                     np.asarray(valid[1])[v_lo:v_hi])
    x_loc = x[lo:hi]
    y_loc = _pad_rows(np.asarray(y_w, np.float32), block)
    w_loc = None
    if w_w is not None or (local_rows and ragged):
        w_src = (np.ones(x_loc.shape[0], np.float32) if w_w is None
                 else np.asarray(w_w, np.float32))
        w_loc = _pad_rows(w_src, block)
    pres = None
    if ragged:
        pres = _pad_rows(np.ones(hi - lo, np.float32), block)
    g_loc = None
    if g_w is not None:
        g_arr = np.asarray(g_w, np.int32)
        g_loc = _pad_rows(g_arr, block, fill=int(g_arr.max()) + 1)
    i_loc = None if i_w is None else _pad_rows(
        np.asarray(i_w, np.float32), block)

    if prebinned is not None:
        mapper, bins = prebinned[0], prebinned[1]
        staged_y = prebinned[2] if len(prebinned) == 3 else None
        if not local_rows:
            bins = bins[lo:hi]
            staged_y = None if staged_y is None else staged_y[lo:hi]
    else:
        if local_rows:
            mapper = cluster.broadcast_from_leader(
                binning.fit_bins(np.asarray(x_loc, np.float32),
                                 max_bin=p.max_bin, seed=p.seed,
                                 categorical_features=p.categorical_features)
                if pid == 0 else None)
        else:
            # over the padded table, as the one-process fit fits them
            mapper = binning.fit_bins(
                _pad_rows(np.asarray(x, np.float32), n_pad),
                max_bin=p.max_bin, seed=p.seed,
                categorical_features=p.categorical_features)
        # padding rows are zeros, binned as the one-process fit bins its
        # padded matrix
        x_bin = _pad_rows(np.asarray(x_loc, np.float32), block)
        if oocore is not None:
            from ...data import ChunkStager
            opts = oocore
            if opts.cache_path:
                opts = dataclasses.replace(
                    opts, cache_path=f"{opts.cache_path}.process{pid}")
            bins = ChunkStager(x_bin, mapper, opts).stage(device=first)
        elif ingest is not None:
            from ...data import parallel_apply_bins
            bins = parallel_apply_bins(mapper, x_bin, ingest)
        else:
            bins = binning.apply_bins_device(mapper, x_bin, device=first)
        staged_y = None
    staged = (mapper, _pad_rows(_tensor(bins), block).to(first))
    if staged_y is not None:
        staged += (_pad_rows(_tensor(staged_y), block).to(first),)
    x_fit = (x_loc if x_loc.shape[0] == block
             else _pad_rows(np.asarray(x_loc, np.float32), block))
    return fit_booster(
        x_fit, y_loc, params, weights=w_loc, init_scores=i_loc,
        valid=v_loc, prebinned=staged, group=g_loc, presence=pres,
        base_score=base_score, **common)
