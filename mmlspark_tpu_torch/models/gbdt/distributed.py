"""Data-parallel and voting-parallel GBDT over the port's mesh.

Port of `mmlspark_tpu/models/gbdt/distributed.py`. The reference is
single-controller: a `shard_map` over the mesh's data axis whose tree
grower sums each level's histograms with a `lax.psum`. The port keeps
that form on its own mesh (`parallel/mesh.py`, an ndarray of
`torch.device`s): rows are split over the data axis's positions, each
position builds its histograms with the same kernel a one-position fit
launches, the histograms are added over the positions in position order
on the first position's device, and one split search on the sums decides
for every position (`trainer.train_one_tree_sharded`). Both of the
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

import numpy as np
import torch

from ...device import resolve_device
from ...parallel.mesh import DATA_AXIS, data_mesh, pad_to_multiple
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

    def tree_fn(bins, grad, hess, fmask, cfg, count_w=None, lo_planes=None,
                plane_lo: int = 0, fixed_order: bool = False):
        if len(bins) != n_pos:
            raise ValueError(f"{len(bins)} row shards for a data axis of "
                             f"{n_pos} positions")
        return trainer.train_one_tree_sharded(
            bins, grad, hess, fmask, cfg, count_w=count_w,
            lo_planes=lo_planes, plane_lo=plane_lo, fixed_order=fixed_order,
            voting_top_k=voting)

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
                            mesh=None, device=None, prebinned=None):
    """`fit_booster` with the rows split over the data axis of `mesh`
    (None: `default_mesh(num_tasks, device)`). Returns (booster, base,
    eval_history) as `fit_booster`; the trees are built once from the
    summed histograms, so there is nothing to gather.

    `prebinned=(mapper, bins[, y])` (the port's own, as `fit_booster`'s):
    bins already on the first position's device, padded there. A
    checkpoint's `init_margin` is the padded fit's margin, and resumes
    the fit on the same rows and mesh size. `ingest` and `oocore` pass
    through to `fit_booster` (`x` may then be an .npy path)."""
    if parallelism not in ("data_parallel", "voting_parallel"):
        raise ValueError(f"unknown parallelism {parallelism!r}")
    if mesh is None:
        mesh = default_mesh(num_tasks, device)
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
        prebinned=prebinned, group=group_p, init_booster=init_booster,
        callbacks=callbacks, checkpoint_fn=checkpoint_fn,
        checkpoint_interval=checkpoint_interval, init_base=init_base,
        init_margin=init_margin, init_rng_key=init_rng_key,
        iter_offset=iter_offset, ingest=ingest, oocore=oocore, mesh=mesh,
        voting_top_k=top_k if parallelism == "voting_parallel" else None,
        presence=pres_p)
