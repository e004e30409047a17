"""Boosting loop: gbdt / rf / dart / goss over the level-wise tree grower.

Port of `mmlspark_tpu/models/gbdt/boosting.py`: every objective of
`objectives.py` (lambdarank with its group index, the L1-family leaf
renewal, a custom `fobj`), native categorical splits
(`categorical_features`), sample weights, `init_scores`, `prebinned`
staging, a validation set with early stopping, bagging, feature_fraction,
goss, rf and dart, and the planes histogram route
(`MMLSPARK_TPU_HIST=planes`). The reference fuses a chunk of iterations
into one `lax.scan` where it can and keeps a host loop for dart, renewal,
lambdarank and `fobj`; here every mode runs the host loop's steps as a
plain Python loop of device work. Its host syncs are the per-iteration
metric read when a validation set is tracked, dart's drop set, and the
final tree fetch.

Random draws come from one `torch.Generator` on the fit's device, seeded
anew each iteration from (`seed`, iteration): an iteration's bagging,
GOSS, feature and drop draws depend on the seed and the iteration alone.
They cannot match the reference's threefry streams (ROADMAP Queue 3 (b)).

Checkpoint and resume follow the reference's contract: `checkpoint_fn`
receives the live margin every `checkpoint_interval` iterations, and a fit
given it back as `init_margin`, with `init_booster` (the trees so far) and
`iter_offset` (the iterations done), continues on the same state, so the
resumed model equals an uninterrupted checkpointed fit bit for bit. Such a
fit (one with `checkpoint_fn` or `init_margin`) grows its trees in fixed
order (`trainer.train_one_tree(fixed_order=True)`); other fits keep the
atomic kernels. The port's payload carries no `rng_key`: iteration i's
draws come from (`seed`, i) alone, so `iter_offset` lines them up, and an
`init_rng_key` (a reference checkpoint's threefry key, which cannot seed a
torch generator) is accepted and not used.

Every fit grows its trees over the rows of a mesh's data axis
(`trainer.train_one_tree_sharded`); the plain fit is the one-position
mesh of its device, and `distributed.fit_booster_distributed` passes a
mesh of several (`mesh=`) after padding the rows. The per-row state lives
on the first position's device. Bagging and GOSS draw per position, as
the reference's `fold_in(axis_index)`: position 0 from the iteration's
generator, position q > 0 from one keyed by (`seed`, iteration, q), so a
one-position mesh draws what the plain fit always drew.

Over a mesh whose data axis spans processes (`parallel.cluster`), each
process holds the per-row state of its own rows on its first local
position, and q above is the GLOBAL position index; a process without
position 0 draws position 0's bagging or GOSS numbers from the
iteration's generator all the same (and drops them), so the feature
mask and dart's drops after them are every process's. Every sum over
all rows is global: the trees' sums (`trainer._sum_positions`), the
boost-from-average score (float64 partial sums added in process order,
or the caller's `base_score`), the renewal objectives' leaf quantiles and
the validation metric (the rows gathered in process order), so every
process grows the same trees and takes the same early stop. Lambdarank
groups must not straddle processes.
"""
from __future__ import annotations

import dataclasses
import inspect
import os
from typing import Callable, Optional

import numpy as np
import torch

from ...data import ChunkStager, parallel_apply_bins, stage_binned
from ...device import resolve_device
from ...ops import binning, histogram
from ...parallel import cluster
from ...parallel.mesh import DATA_AXIS, data_mesh, row_sharding
from ...reliability import names as tnames
from ...reliability.metrics import reliability_metrics
from ...utils import tracing
from . import objectives as obj_mod
from . import trainer
from .booster import Booster


@dataclasses.dataclass(frozen=True)
class BoostParams:
    """The reference's parameter set, every field kept."""
    objective: str = "binary"
    boosting: str = "gbdt"            # gbdt | rf | dart | goss
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_depth: int = 5
    max_bin: int = 255
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    feature_fraction: float = 1.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    # goss
    top_rate: float = 0.2
    other_rate: float = 0.1
    # dart
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    uniform_drop: bool = False
    xgboost_dart_mode: bool = False
    # objective extras
    alpha: float = 0.9                # huber delta / quantile level
    tweedie_variance_power: float = 1.5
    # native categorical splits
    categorical_features: tuple = ()
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    # multiclass / ranking
    num_class: int = 1
    sigmoid: float = 1.0
    max_position: int = 0
    # user-supplied objective: (margin, y) -> (grad, hess)
    fobj: Optional[Callable] = None
    rf_total: int = 0
    # control
    seed: int = 0
    early_stopping_round: int = 0
    metric: Optional[str] = None
    boost_from_average: bool = True
    verbosity: int = -1


@dataclasses.dataclass
class Callbacks:
    """Delegate hooks, the reference's (LightGBM's delegate):
    `before_iteration(it)`, `after_iteration(it, metric)` (NaN when no
    metric is tracked) and `get_learning_rate(it)`, the iteration's
    shrinkage (rf keeps 1 / total)."""
    before_iteration: Optional[Callable[[int], None]] = None
    after_iteration: Optional[Callable[[int, float], None]] = None
    get_learning_rate: Optional[Callable[[int], float]] = None


# objectives whose leaf outputs are refit to a residual quantile
RENEWAL_OBJECTIVES = ("regression_l1", "quantile", "huber")
BOOSTING_MODES = ("gbdt", "rf", "dart", "goss")


def check_ported(p: BoostParams) -> None:
    """ValueError for an unknown objective or boosting mode."""
    if p.boosting not in BOOSTING_MODES:
        raise ValueError(f"unknown boosting {p.boosting!r}")
    if p.objective != "lambdarank" and p.objective not in obj_mod.OBJECTIVES:
        raise ValueError(f"unknown objective {p.objective!r}")


def _grad_hess(p: BoostParams, margin, y_j, y_onehot, g_idx):
    if p.fobj is not None:
        grad, hess = p.fobj(margin, y_j)
        return (torch.as_tensor(grad, dtype=torch.float32,
                                device=margin.device),
                torch.as_tensor(hess, dtype=torch.float32,
                                device=margin.device))
    if p.objective == "multiclass":
        return obj_mod.multiclass_grad_hess(margin, y_onehot)
    if p.objective == "binary":
        return obj_mod.binary_grad_hess(margin, y_j, p.sigmoid)
    if p.objective == "lambdarank":
        return obj_mod.lambdarank_grad_hess(margin, y_j, g_idx,
                                            sigmoid=p.sigmoid,
                                            max_position=p.max_position)
    if p.objective in ("huber", "quantile"):
        return obj_mod.OBJECTIVES[p.objective](margin, y_j, p.alpha)
    if p.objective == "tweedie":
        return obj_mod.tweedie_grad_hess(margin, y_j, p.tweedie_variance_power)
    return obj_mod.OBJECTIVES[p.objective](margin, y_j)


def _iteration_seed(seed: int, it: int) -> int:
    """The generator's seed for iteration `it` of a fit seeded `seed`."""
    return int(np.random.SeedSequence((seed % 2 ** 64, it))
               .generate_state(1, np.uint64)[0])


def _position_seed(seed: int, it: int, position: int) -> int:
    """The generator's seed for one mesh position's bagging/GOSS draws:
    the iteration's own seed at position 0."""
    if position == 0:
        return _iteration_seed(seed, it)
    return int(np.random.SeedSequence((seed % 2 ** 64, it, position))
               .generate_state(1, np.uint64)[0])


def _presence(pres_j, row_w):
    """min_data_in_leaf count indicator (None when every row counts):
    rows the bagging/GOSS weights drop and the mesh's padding rows
    (`pres_j` 0) are absent. User sample weights deliberately do NOT
    change counts (LightGBM semantics)."""
    present = None if pres_j is None else pres_j != 0
    if row_w is not None:
        present = row_w != 0 if present is None else present & (row_w != 0)
    return None if present is None else present.to(torch.float32)


def _cat_positions(parts):
    """The positions' row blocks as one tensor (one block as it is); None
    where the positions hold none."""
    if parts[0] is None:
        return None
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _row_weights(p: BoostParams, grad, gen, it: int, multiclass: bool):
    """Per-iteration GOSS / bagging row weights (None = keep all)."""
    n = grad.shape[0]
    if p.boosting == "goss":
        g_abs = grad.abs().sum(-1) if multiclass else grad.abs()
        n_top = max(int(p.top_rate * n), 1)
        thresh = torch.sort(g_abs).values[n - n_top]
        is_top = g_abs >= thresh
        rnd = torch.rand(n, generator=gen, device=grad.device)
        keep_other = (~is_top) & (rnd < p.other_rate
                                  / max(1 - p.top_rate, 1e-9))
        amp = (1.0 - p.top_rate) / max(p.other_rate, 1e-9)
        return torch.where(is_top, 1.0, torch.where(keep_other, amp, 0.0))
    rf = p.boosting == "rf"
    if p.bagging_fraction < 1.0 and (rf or p.bagging_freq > 0):
        if not rf and p.bagging_freq > 1 and it % p.bagging_freq != 0:
            return None     # off-phase iterations keep every row
        return (torch.rand(n, generator=gen, device=grad.device)
                < p.bagging_fraction).to(torch.float32)
    return None


def _feature_mask(p: BoostParams, gen, n_features: int):
    """Per-tree feature subsample: exactly max(1, round(ff * F)) features."""
    dev = gen.device
    if p.feature_fraction < 1.0:
        kf = max(1, int(round(p.feature_fraction * n_features)))
        perm = torch.randperm(n_features, generator=gen, device=dev)
        mask = torch.zeros(n_features, dtype=torch.bool, device=dev)
        mask[perm[:kf]] = True
        return mask
    return torch.ones(n_features, dtype=torch.bool, device=dev)


def _dart_drops(p: BoostParams, gen, n_prev: int) -> list:
    """Indices of earlier iterations dart drops this iteration: none with
    probability skip_drop, else each with probability
    min(drop_rate, max_drop / n_prev). One host sync."""
    if n_prev == 0:
        return []
    u = torch.rand(n_prev + 1, generator=gen, device=gen.device).cpu()
    if float(u[0]) < p.skip_drop:
        return []
    drop_p = min(p.drop_rate, p.max_drop / max(n_prev, 1))
    return np.nonzero(u[1:].numpy() < drop_p)[0].tolist()


def _leaf_quantiles(nodes, resid, keep, q: float, n_nodes: int):
    """Per heap node: the q-quantile of `resid` over its rows where `keep`
    (None = all), with numpy's default linear interpolation, and whether
    the node has any such row. One sort of every row by (node, resid), so
    a leaf may hold any number of rows (`torch.quantile` refuses more than
    2^24)."""
    n = resid.shape[0]
    slot = nodes if keep is None else torch.where(keep, nodes, n_nodes)
    order = torch.argsort(resid, stable=True)
    order = order[torch.argsort(slot[order], stable=True)]
    ranked = resid[order].to(torch.float64)
    counts = torch.bincount(slot, minlength=n_nodes + 1)[:n_nodes]
    starts = torch.cumsum(counts, 0) - counts
    last = (counts - 1).clamp(min=0)
    pos = q * last.to(torch.float64)
    below = pos.floor().to(torch.int64)
    t = pos - below
    a = ranked[(starts + below).clamp(max=n - 1)]
    b = ranked[(starts + torch.minimum(below + 1, last)).clamp(max=n - 1)]
    val = torch.where(t >= 0.5, b - (b - a) * (1 - t), a + (b - a) * t)
    return val, counts > 0


def _gather_rows(t, exchange):
    """A per-row tensor with every process's rows, in process order (the
    tensor itself without an exchange)."""
    if exchange is None or t is None:
        return t
    if t.dtype == torch.bool:
        return exchange.gather_rows(t.to(torch.uint8)).to(torch.bool)
    return exchange.gather_rows(t)


def _global_init_score(objective: str, y, weights, presence):
    """`objectives.init_score` over the rows of every process: the
    weighted mean from float64 partial sums added in process order, a
    median from the gathered labels. Padding rows (`presence` 0) count
    as weight 0, as `fit_booster_distributed` weights them."""
    y = np.asarray(y, np.float64)
    w = (np.ones_like(y) if weights is None
         else np.asarray(weights, np.float64))
    if presence is not None:
        w = w * (np.asarray(presence) != 0)
    if objective in ("regression_l1", "quantile"):
        keep = w > 0
        y_all = np.concatenate(cluster.all_gather_object(y[keep]))
        return obj_mod.init_score(objective, y_all)
    sums = cluster.all_gather_object((float((w * y).sum()),
                                      float(w.sum())))
    total_wy = total_w = 0.0
    for wy, ws in sums:
        total_wy += wy
        total_w += ws
    mean = total_wy / total_w if total_w else 0.0
    return obj_mod.init_score(objective, np.array([mean]))


def _check_groups_local(group, presence) -> None:
    """Lambdarank over processes: a group's rows must all lie in one
    process (its gradients pair rows within the group)."""
    ids = np.asarray(group)
    if presence is not None:
        ids = ids[np.asarray(presence) != 0]
    seen: dict = {}
    for pid, mine in enumerate(cluster.all_gather_object(np.unique(ids))):
        for g in mine.tolist():
            if g in seen:
                raise ValueError(
                    f"lambdarank group {g} straddles processes {seen[g]} "
                    f"and {pid}: give each process whole groups")
            seen[g] = pid


def _renew_leaves(tree, d_bins, resid, keep, q: float, lr: float,
                  max_depth: int, exchange=None):
    """L1-family leaf renewal (LightGBM's RenewTreeOutput): each leaf's
    output becomes lr x the q-quantile of the residuals resting there,
    over every process's rows with an `exchange`. Returns the renewed
    tree and its per-row delta."""
    nodes = trainer.leaf_of_binned(d_bins, tree.split_feature,
                                   tree.split_bin, max_depth,
                                   tree.split_is_cat, tree.cat_words)
    val, has = _leaf_quantiles(
        _gather_rows(nodes, exchange), _gather_rows(resid, exchange),
        _gather_rows(keep, exchange), q, tree.leaf_value.shape[0])
    lv = torch.where(has, (lr * val).to(torch.float32), tree.leaf_value)
    return tree._replace(leaf_value=lv), lv[nodes]


def _device_metric(name, objective, margin, y):
    """(metric value as a 0-d f32 tensor, larger_is_better), computed on
    the device as the reference's `_device_metric` computes it."""
    if name is None:
        name = {"binary": "binary_logloss", "multiclass": "multi_logloss",
                "lambdarank": "l2"}.get(objective, "l2")
    if name == "auc":
        order = torch.argsort(margin, stable=True)
        ranks = torch.empty_like(margin)
        ranks[order] = torch.arange(1, margin.shape[0] + 1,
                                    dtype=margin.dtype, device=margin.device)
        npos = y.sum()
        nneg = y.shape[0] - npos
        val = ((torch.where(y == 1, ranks, 0.0).sum() - npos * (npos + 1) / 2)
               / torch.clamp(npos * nneg, min=1.0))
        return val, True
    if name == "binary_logloss":
        pr = torch.clamp(torch.sigmoid(margin), 1e-15, 1 - 1e-15)
        return -(y * torch.log(pr) + (1 - y) * torch.log(1 - pr)).mean(), False
    if name == "multi_logloss":
        logp = torch.log_softmax(margin, dim=-1)
        return -logp.gather(1, y.to(torch.int64)[:, None]).mean(), False
    m = margin if margin.dim() == 1 else margin[:, 0]
    return ((m - y) ** 2).mean(), False


def _build_booster(sf, sb, lv, tree_classes, mapper, p: BoostParams,
                   k_out: int, n_features: int, best_iter: int,
                   gain=None, cover=None, is_cat=None, cat_words=None,
                   init_booster=None):
    """Stacked tree arrays -> Booster with real-valued thresholds, after
    `init_booster`'s trees where there is one. Categorical nodes keep
    threshold 0: they route by their words. A booster with no categorical
    split carries no categorical arrays."""
    thr = mapper.upper_bounds[np.clip(sf, 0, n_features - 1),
                              np.clip(sb, 0, p.max_bin - 1)]
    thr = np.where(sf >= 0, thr, 0.0).astype(np.float32)
    has_cat = (is_cat is not None and cat_words is not None
               and cat_words.size and is_cat.any())
    if has_cat:
        thr = np.where(is_cat, 0.0, thr).astype(np.float32)
    booster = Booster(
        split_feature=sf.astype(np.int32), threshold=thr,
        split_bin=sb.astype(np.int32), leaf_value=lv.astype(np.float32),
        tree_class=np.asarray(tree_classes, np.int32),
        max_depth=p.max_depth, n_classes=k_out, objective=p.objective,
        n_features=n_features, best_iteration=best_iter,
        gain=None if gain is None else gain.astype(np.float32),
        cover=None if cover is None else cover.astype(np.float32),
        split_is_cat=is_cat.astype(bool) if has_cat else None,
        cat_words=cat_words.astype(np.int32) if has_cat else None)
    return booster if init_booster is None else init_booster.merge(booster)


def _fetch_trees(trees, cfg, dart_weights, k_out: int):
    """ONE device->host copy of every tree array: (split_feature,
    split_bin, leaf_value, gain, cover, split_is_cat, cat_words) stacked
    over trees (the last two None without categorical features; the
    words are < 2^16, exact in f32), dart's iteration weights folded into
    the leaf values."""
    max_nodes, w16 = cfg.max_nodes, cfg.cat_words_width
    n_cols = 6 + w16 if w16 else 5
    if trees:
        packed = torch.stack([torch.cat(
            [t.split_feature.to(torch.float32), t.split_bin.to(torch.float32),
             t.leaf_value, t.gain, t.cover]
            + ([t.split_is_cat.to(torch.float32),
                t.cat_words.to(torch.float32).reshape(-1)] if w16 else []))
            for t in trees]).cpu().numpy()
    else:
        packed = np.zeros((0, n_cols * max_nodes), np.float32)
    sf, sb, lv, gn, cv = [packed[:, i * max_nodes:(i + 1) * max_nodes]
                          for i in range(5)]
    ic = cw = None
    if w16:
        ic = packed[:, 5 * max_nodes:6 * max_nodes] > 0.5
        cw = packed[:, 6 * max_nodes:].reshape(-1, max_nodes, w16).astype(
            np.int32)
    if dart_weights and trees:  # each tree carries its iteration's weight
        lv = lv * np.repeat(np.asarray(dart_weights, np.float32),
                            k_out)[:, None]
    return sf.astype(np.int32), sb.astype(np.int32), lv, gn, cv, ic, cw


def _checkpoint_caller(checkpoint_fn):
    """`checkpoint_fn` as (it, booster, base, final=, margin=, rng_key=)
    with the margin as host numpy; a callback of the legacy signature
    (it, booster, base, final=False) is called without the last two, as
    the reference calls it (it then loses exact-resume margins)."""
    try:
        ck_params = inspect.signature(checkpoint_fn).parameters
        extended = ("margin" in ck_params
                    or any(q.kind == q.VAR_KEYWORD
                           for q in ck_params.values()))
    except (TypeError, ValueError):
        extended = True

    def call(it, booster, fit_base, final=False, margin=None, rng_key=None):
        if not extended:
            return checkpoint_fn(it, booster, fit_base, final=final)
        if margin is not None:
            margin = margin.detach().cpu().numpy()
        return checkpoint_fn(it, booster, fit_base, final=final,
                             margin=margin, rng_key=rng_key)
    return call


def fit_booster(x: np.ndarray, y: np.ndarray, params: BoostParams,
                weights: Optional[np.ndarray] = None,
                init_scores: Optional[np.ndarray] = None,
                valid: Optional[tuple] = None,
                prebinned: Optional[tuple] = None,
                device=None, group=None, init_booster=None, callbacks=None,
                checkpoint_fn=None, checkpoint_interval: int = 25,
                init_base: float = 0.0,
                init_margin: Optional[np.ndarray] = None,
                init_rng_key=None, iter_offset: int = 0,
                ingest=None, oocore=None, mesh=None,
                voting_top_k: Optional[int] = None,
                presence: Optional[np.ndarray] = None,
                base_score: Optional[float] = None):
    """Train a Booster. Returns (booster, base, eval_history) like the
    reference.

    `prebinned=(mapper, bins[, y])`: data already binned (and optionally
    labels staged) on the device, so a timed fit measures the training
    loop alone; `y` stays a host array for the init-score statistics.
    `group`: per-row query ids, for `objective="lambdarank"`.
    `device`: None = the card (raises without one); tests pass "cpu".
    With `MMLSPARK_TPU_HIST=planes` in the environment, the fit builds
    the histogram plan once (`ops.histogram.build_hist_plan`) and every
    tree's shallow levels take the planes histogram.

    Continuation and checkpoints, as the reference: `init_booster`'s trees
    come first and the new ones fit its residuals (scored by
    `init_booster.raw_score` unless `init_margin`, a checkpoint's live
    margin, is given), from `init_base`; `callbacks` (`Callbacks`);
    `checkpoint_fn(it, booster, base, final=, margin=, rng_key=)` every
    `checkpoint_interval` iterations and at an early stop (final=True);
    `iter_offset`: iterations done before this fit, for the draws and the
    bagging phase. `init_rng_key` is not used (the module docstring).

    `ingest` (a `data.IngestOptions`) builds the bin matrix with the
    parallel host pipeline: chunked multi-worker binning overlapped with
    the per-chunk copy to the card (`data.stage_binned`), or, over a mesh
    of several positions, `data.parallel_apply_bins` and one placement.
    `oocore` (a `data.OocoreOptions`) takes precedence: chunked binning
    under a residency budget with a durable resume cursor
    (`data.ChunkStager`; `x` may be an .npy path, memory-mapped here). The
    bins, and so the fit, equal the serial path's bit for bit.

    `mesh`: grow every tree over the rows split across the mesh's data
    axis (the row count must divide; `fit_booster_distributed` pads),
    the fit's state on the first position's device (`device` is then not
    used); `voting_top_k`: PV-tree voting over it; `presence`: per-row 1 /
    0 for real / padding rows, which never count toward min_data_in_leaf;
    `base_score`: the boost-from-average score, computed by the caller
    over all rows (None: from `y`).

    A mesh whose data axis spans processes takes this process's rows: `x`,
    `y`, `weights`, `init_scores`, `group`, `presence`, `valid` and
    `init_margin` are its own, and `prebinned` is required (bins from one
    mapper on every process; `fit_booster_distributed` makes them). The
    module docstring says what is global.
    """
    if isinstance(x, str):
        # out-of-core source: an .npy path memory-maps here, so nothing
        # below holds the raw matrix in host memory
        x = np.load(x, mmap_mode="r")
    p = params
    check_ported(p)
    cb = callbacks or Callbacks()
    n, n_features = x.shape
    if p.objective == "lambdarank" and group is None:
        raise ValueError("objective='lambdarank' needs per-row group ids")
    if group is not None and len(group) != n:
        raise ValueError(f"group has {len(group)} ids for {n} rows")
    if mesh is None:
        # the plain fit is the one-position case of the mesh's, in this
        # process alone even in a multi-process job
        mesh = data_mesh(devices=[resolve_device(device)],
                         span_processes=False)
    positions = mesh.axis_devices(DATA_AXIS)
    n_pos = len(positions)
    if n % n_pos:
        raise ValueError(f"{n} rows do not split over {n_pos} positions; "
                         f"fit_booster_distributed pads them")
    dev = positions[0]
    exchange = mesh.exchange if mesh.process_count > 1 else None
    if exchange is not None and prebinned is None:
        raise ValueError(
            "a mesh that spans processes needs prebinned=(mapper, bins"
            "[, y]) with one mapper on every process; "
            "fit_booster_distributed bins the rows")
    if exchange is not None and group is not None:
        _check_groups_local(group, presence)
    multiclass = p.objective == "multiclass"
    k_out = p.num_class if multiclass else 1
    # a fit that checkpoints or resumes grows its trees in fixed order, so
    # that its resumed continuation equals the uninterrupted fit bit for bit
    fixed_order = checkpoint_fn is not None or init_margin is not None
    if checkpoint_fn is not None:
        checkpoint_fn = _checkpoint_caller(checkpoint_fn)
    iter_offset = int(iter_offset)

    staged_y = None
    if prebinned is not None:
        if len(prebinned) == 3:
            mapper, d_bins, staged_y = prebinned
        else:
            mapper, d_bins = prebinned
        d_bins = torch.as_tensor(d_bins).to(dev)
    else:
        with tracing.wall_clock(tnames.DATA_FIT_BINS,
                                sink=reliability_metrics.observe):
            mapper = binning.fit_bins(
                x, max_bin=p.max_bin, seed=p.seed,
                categorical_features=p.categorical_features)
        # over a mesh of several positions the host matrix is placed once
        # on the first position's device and cut by `row_sharding` below
        place = None
        if n_pos > 1:
            def place(host):
                return torch.from_numpy(np.asarray(host)).to(dev, copy=True)
        if oocore is not None:
            d_bins = ChunkStager(x, mapper, oocore).stage(put=place,
                                                         device=dev)
        elif ingest is not None:
            if place is None:
                # one device: chunk binning overlaps the copies to it
                d_bins = stage_binned(mapper, x, ingest, device=dev)
            else:
                d_bins = place(parallel_apply_bins(mapper, x, ingest))
        else:
            d_bins = binning.apply_bins_device(mapper, x, device=dev)
    # the level-invariant histogram plan, once per fit, where the
    # reference builds it (it also sets a plan-bytes gauge there; gauges
    # are telemetry, ROADMAP Queue 1 item 23)
    # each position's rows on its device: views of d_bins on one card
    rows = row_sharding(mesh)
    bin_shards = rows.put(d_bins)
    lo_planes, plane_lo = None, 0
    if os.environ.get("MMLSPARK_TPU_HIST") == "planes":
        plane_lo = histogram.plan_lo_bins(p.max_bin + 1)
        if plane_lo:
            lo_planes = [histogram.build_hist_plan(b, p.max_bin + 1)
                         for b in bin_shards]

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    y_j = (torch.as_tensor(staged_y).to(dev, torch.float32)
           if staged_y is not None else put(y))
    w_j = None if weights is None else put(weights)
    pres_j = None if presence is None else put(presence)
    y_onehot = (torch.nn.functional.one_hot(y_j.to(torch.int64), p.num_class)
                .to(torch.float32) if multiclass else None)
    g_idx = (torch.as_tensor(obj_mod.make_group_index(group)).to(dev)
             if group is not None else None)

    base = 0.0
    if init_booster is not None:
        # continuation: the new trees fit the residuals of the restored
        # ensemble, whose base carries over
        base = float(init_base)
    elif p.boost_from_average and init_scores is None and not multiclass:
        if base_score is not None:
            base = float(base_score)
        elif exchange is not None:
            base = _global_init_score(p.objective, y, weights, presence)
        else:
            base = obj_mod.init_score(p.objective, y, weights=weights)
    cont = None
    if init_booster is not None and init_margin is None:
        # a warm start or a checkpoint without a margin: score the
        # restored ensemble (its float sums need not equal the live
        # margin's, so such a resume is not bit-exact)
        cont = init_booster.raw_score(x, device=dev)            # (n, K)
    if multiclass:
        margin = torch.zeros((n, p.num_class), dtype=torch.float32, device=dev)
        if init_scores is not None:
            init_arr = np.asarray(init_scores, dtype=np.float32)
            if init_arr.shape != (n, p.num_class):
                raise ValueError(
                    f"multiclass init_scores must be (n, num_class)="
                    f"({n}, {p.num_class}), got {init_arr.shape}")
            margin = margin + put(init_arr)
    else:
        margin = torch.full((n,), base, dtype=torch.float32, device=dev)
        if init_scores is not None:
            margin = margin + put(init_scores)
    # rf: every tree's gradients start at the margin before any restored
    # ensemble, so resumed trees fit the same target as the first ones
    rf_margin = margin
    if cont is not None:
        margin = margin + put(cont if multiclass else cont[:, 0])
    if init_margin is not None:
        # the checkpoint's live margin REPLACES the reconstruction: the
        # resumed state is the uninterrupted fit's, bit for bit. It only
        # makes sense against the same rows.
        init_margin = np.asarray(init_margin, np.float32)
        if init_margin.shape != tuple(margin.shape):
            raise ValueError(
                f"init_margin has shape {init_margin.shape} but this fit's "
                f"margin is {tuple(margin.shape)}: the checkpoint was saved "
                f"against different data; delete the checkpoint dir (or "
                f"drop init_margin) to restart from the restored trees "
                f"alone")
        margin = put(init_margin)
    rf = p.boosting == "rf"
    if not (rf and init_booster is not None):
        rf_margin = margin

    has_valid = valid is not None
    v_margin = v_it_delta = None
    if has_valid:
        vx, vy = valid
        if ingest is not None:
            v_bins = torch.from_numpy(
                parallel_apply_bins(mapper, vx, ingest)).to(dev)
        else:
            v_bins = binning.apply_bins_device(mapper, vx, device=dev)
        vy_j = put(vy)
        v_margin = (torch.zeros((vx.shape[0], p.num_class),
                                dtype=torch.float32, device=dev)
                    if multiclass else
                    torch.full((vx.shape[0],), base, dtype=torch.float32,
                               device=dev))
        if init_booster is not None:
            v_init = put(init_booster.raw_score(vx, device=dev))
            v_margin = v_margin + (v_init if multiclass else v_init[:, 0])

    dart = p.boosting == "dart"
    cfg = trainer.TreeConfig(
        n_features=n_features, n_bins=p.max_bin + 1, max_depth=p.max_depth,
        num_leaves=p.num_leaves, learning_rate=p.learning_rate,
        lambda_l1=p.lambda_l1, lambda_l2=p.lambda_l2,
        min_gain_to_split=p.min_gain_to_split,
        min_data_in_leaf=p.min_data_in_leaf,
        min_sum_hessian_in_leaf=p.min_sum_hessian_in_leaf,
        categorical_features=tuple(int(i) for i in p.categorical_features),
        cat_smooth=p.cat_smooth, cat_l2=p.cat_l2,
        max_cat_threshold=p.max_cat_threshold)
    renew_q = (None if p.objective not in RENEWAL_OBJECTIVES else
               p.alpha if p.objective == "quantile" else 0.5)
    gen = torch.Generator(device=dev)
    # one generator per mesh position; global position 0's is the fit's
    # own, and q_off is this process's first global position
    q_off = mesh.position_offset
    gens = [gen if q_off + q == 0 else torch.Generator(device=dev)
            for q in range(n_pos)]
    patience = p.early_stopping_round
    track = has_valid and (patience > 0 or p.metric is not None)
    trees, eval_history = [], []
    train_deltas, val_deltas, dart_weights = [], [], []
    best_metric, best_iter, rounds_since = None, -1, 0
    n_grown = 0

    def booster_so_far(best):
        sf, sb, lv, gn, cv, ic, cw = _fetch_trees(trees, cfg, dart_weights,
                                                  k_out)
        return _build_booster(
            sf, sb, lv, np.tile(np.arange(k_out, dtype=np.int32),
                                len(trees) // k_out),
            mapper, p, k_out, n_features, best, gain=gn, cover=cv,
            is_cat=ic, cat_words=cw, init_booster=init_booster)

    for it in range(p.num_iterations):
        if cb.before_iteration:
            cb.before_iteration(it)
        lr = (1.0 / (p.rf_total or p.num_iterations) if rf
              else cb.get_learning_rate(it) if cb.get_learning_rate
              else p.learning_rate)
        cfg = cfg._replace(learning_rate=lr)
        # the draws of the absolute iteration, so that a resumed fit
        # (iter_offset = iterations done) draws as the uninterrupted one
        gen.manual_seed(_iteration_seed(p.seed, it + iter_offset))
        # dart: drop a subset of earlier iterations from this one's margin
        dropped = _dart_drops(p, gen, len(train_deltas)) if dart else []
        if dropped:
            margin_used = margin
            for t_i in dropped:
                margin_used = (margin_used
                               - train_deltas[t_i] * dart_weights[t_i])
        elif rf:
            margin_used = rf_margin
        else:
            margin_used = margin

        grad, hess = _grad_hess(p, margin_used, y_j, y_onehot, g_idx)
        if w_j is not None:
            grad = grad * (w_j[:, None] if multiclass else w_j)
            hess = hess * (w_j[:, None] if multiclass else w_j)
        # each position draws over its own rows (GOSS ranks them
        # locally), as the reference's per-shard fold_in
        for q in range(n_pos):
            if q_off + q:
                gens[q].manual_seed(_position_seed(
                    p.seed, it + iter_offset, q_off + q))
        chunks = grad.chunk(n_pos)
        if q_off:
            # position 0 draws from `gen` on its own process: draw the
            # same numbers here (positions have equal rows) and drop them
            _row_weights(p, chunks[0], gen, it + iter_offset, multiclass)
        parts = [_row_weights(p, g_q, gens[q], it + iter_offset, multiclass)
                 for q, g_q in enumerate(chunks)]
        row_w = _cat_positions(parts)
        if row_w is not None:
            grad = grad * (row_w[:, None] if multiclass else row_w)
            hess = hess * (row_w[:, None] if multiclass else row_w)
        fmask = _feature_mask(p, gen, n_features)
        count_w = _presence(pres_j, row_w)

        it_deltas = torch.zeros_like(margin) if multiclass else 0.0
        if has_valid:
            v_it_delta = torch.zeros_like(v_margin) if multiclass else 0.0
        for k in range(k_out):
            gk = grad[:, k] if multiclass else grad
            hk = hess[:, k] if multiclass else hess
            tree, deltas = trainer.train_one_tree_sharded(
                bin_shards, rows.put(gk), rows.put(hk), fmask, cfg,
                count_w=None if count_w is None else rows.put(count_w),
                lo_planes=lo_planes, plane_lo=plane_lo,
                fixed_order=fixed_order, voting_top_k=voting_top_k,
                exchange=exchange)
            delta = _cat_positions([d.to(dev) for d in deltas])
            if renew_q is not None:
                tree, delta = _renew_leaves(
                    tree, d_bins, y_j - margin_used,
                    None if w_j is None else w_j > 0, renew_q, lr,
                    cfg.max_depth, exchange)
            trees.append(tree)
            if multiclass:
                it_deltas[:, k] += delta
            else:
                it_deltas = delta
            if has_valid:
                vd = trainer.predict_binned(v_bins, tree.split_feature,
                                            tree.split_bin, tree.leaf_value,
                                            cfg.max_depth, tree.split_is_cat,
                                            tree.cat_words)
                if multiclass:
                    v_it_delta[:, k] += vd
                else:
                    v_it_delta = vd
        n_grown += 1

        if dart:
            # LightGBM's weight normalization; with nothing dropped the new
            # iteration's weight is 1 (xgboost mode: the learning rate)
            k_dropped = len(dropped)
            new_w = lr if p.xgboost_dart_mode else 1.0 / (k_dropped + 1.0)
            scale = k_dropped / (k_dropped + 1.0)
            for t_i in dropped:
                shrink = dart_weights[t_i] * (1 - scale)
                margin = margin - train_deltas[t_i] * shrink
                if has_valid:
                    v_margin = v_margin - val_deltas[t_i] * shrink
                dart_weights[t_i] *= scale
            train_deltas.append(it_deltas)
            dart_weights.append(new_w)
            margin = margin + it_deltas * new_w
            if has_valid:
                val_deltas.append(v_it_delta)
                v_margin = v_margin + v_it_delta * new_w
        else:
            margin = margin + it_deltas
            if has_valid:
                v_margin = v_margin + v_it_delta

        mv = float("nan")
        if track:
            # over every process's validation rows: each process reads the
            # same value and takes the same early stop
            mv, larger = _device_metric(p.metric, p.objective,
                                        _gather_rows(v_margin, exchange),
                                        _gather_rows(vy_j, exchange))
            mv = float(mv)      # the early-stopping decision needs the host
            eval_history.append(mv)
            if (best_metric is None
                    or ((mv > best_metric) == larger and mv != best_metric)):
                best_metric, best_iter, rounds_since = mv, it, 0
            else:
                rounds_since += 1
                if patience > 0 and rounds_since >= patience:
                    if cb.after_iteration:
                        cb.after_iteration(it, mv)
                    break
        if cb.after_iteration:
            cb.after_iteration(it, mv)
        if (checkpoint_fn is not None
                and (it + 1) % max(int(checkpoint_interval), 1) == 0):
            checkpoint_fn(it + 1, booster_so_far(-1), base, final=False,
                          margin=margin, rng_key=None)

    booster = booster_so_far(best_iter if (track and patience > 0) else -1)
    if (checkpoint_fn is not None and patience > 0
            and rounds_since >= patience):
        # early stop: the truncated model, marked complete, so that a
        # re-fit does not continue past the stop
        checkpoint_fn(n_grown, booster, base, final=True)
    return booster, base, eval_history
