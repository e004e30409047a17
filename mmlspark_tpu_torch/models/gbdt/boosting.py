"""Boosting loop: gbdt over the level-wise tree grower.

Port of `mmlspark_tpu/models/gbdt/boosting.py` for `boosting="gbdt"`: the
objectives of `objectives.py` (lambdarank and the L1-family leaf renewal
excepted), sample weights, `init_scores`, `prebinned` staging, and a
validation set with early stopping. The reference fuses a chunk of
iterations into one `lax.scan`; here the iterations are a plain Python
loop of device work, and the only host syncs are the per-iteration
metric read when a validation set is tracked and the final tree fetch.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ...device import resolve_device
from ...ops import binning
from . import objectives as obj_mod
from . import trainer
from .booster import Booster


@dataclasses.dataclass(frozen=True)
class BoostParams:
    """The reference's parameter set, every field kept; those this slice
    does not port raise in `check_ported`."""
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


# objectives whose leaf outputs the reference refits on the host
RENEWAL_OBJECTIVES = ("regression_l1", "quantile", "huber")


def check_ported(p: BoostParams) -> None:
    """Raise NotImplementedError, naming the ROADMAP item that will port
    it, for every setting this slice does not run."""
    todo = []
    if p.boosting != "gbdt":
        todo.append((f"boosting={p.boosting!r}", 8))
    if p.bagging_fraction < 1.0 or p.feature_fraction < 1.0:
        todo.append(("bagging_fraction/feature_fraction < 1", 8))
    if p.categorical_features:
        todo.append(("categorical features", 9))
    if p.objective == "lambdarank" or p.objective in RENEWAL_OBJECTIVES:
        todo.append((f"objective={p.objective!r}", 10))
    elif p.objective not in obj_mod.OBJECTIVES:
        raise ValueError(f"unknown objective {p.objective!r}")
    if p.fobj is not None:
        todo.append(("custom objective fobj", 10))
    if todo:
        what, item = todo[0]
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP Queue 1 item {item})")


def _unported(name: str, item: int):
    raise NotImplementedError(
        f"fit_booster({name}=...) is not ported yet "
        f"(ROADMAP Queue 1 item {item})")


def _grad_hess(p: BoostParams, margin, y_j, y_onehot):
    if p.objective == "multiclass":
        return obj_mod.multiclass_grad_hess(margin, y_onehot)
    if p.objective == "binary":
        return obj_mod.binary_grad_hess(margin, y_j, p.sigmoid)
    if p.objective == "tweedie":
        return obj_mod.tweedie_grad_hess(margin, y_j, p.tweedie_variance_power)
    return obj_mod.OBJECTIVES[p.objective](margin, y_j)


def _device_metric(name, objective, margin, y):
    """(metric value as a 0-d f32 tensor, larger_is_better), computed on
    the device as the reference's `_device_metric` computes it."""
    if name is None:
        name = {"binary": "binary_logloss",
                "multiclass": "multi_logloss"}.get(objective, "l2")
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
                   gain=None, cover=None):
    """Stacked tree arrays -> Booster with real-valued thresholds."""
    thr = mapper.upper_bounds[np.clip(sf, 0, n_features - 1),
                              np.clip(sb, 0, p.max_bin - 1)]
    thr = np.where(sf >= 0, thr, 0.0).astype(np.float32)
    return Booster(split_feature=sf.astype(np.int32), threshold=thr,
                   split_bin=sb.astype(np.int32),
                   leaf_value=lv.astype(np.float32),
                   tree_class=np.asarray(tree_classes, np.int32),
                   max_depth=p.max_depth, n_classes=k_out,
                   objective=p.objective, n_features=n_features,
                   best_iteration=best_iter,
                   gain=None if gain is None else gain.astype(np.float32),
                   cover=None if cover is None else cover.astype(np.float32))


def fit_booster(x: np.ndarray, y: np.ndarray, params: BoostParams,
                weights: Optional[np.ndarray] = None,
                init_scores: Optional[np.ndarray] = None,
                valid: Optional[tuple] = None,
                prebinned: Optional[tuple] = None,
                device=None, group=None, init_booster=None, callbacks=None,
                checkpoint_fn=None, ingest=None, oocore=None):
    """Train a Booster. Returns (booster, base, eval_history) like the
    reference.

    `prebinned=(mapper, bins[, y])`: data already binned (and optionally
    labels staged) on the device, so a timed fit measures the training
    loop alone; `y` stays a host array for the init-score statistics.
    `device`: None = the card (raises without one); tests pass "cpu".
    `group`, `init_booster`, `callbacks`, `checkpoint_fn`, `ingest` and
    `oocore` belong to later slices and raise NotImplementedError.
    """
    for name, val, item in (("group", group, 10),
                            ("init_booster", init_booster, 11),
                            ("callbacks", callbacks, 11),
                            ("checkpoint_fn", checkpoint_fn, 11),
                            ("ingest", ingest, 17), ("oocore", oocore, 17)):
        if val is not None:
            _unported(name, item)
    p = params
    check_ported(p)
    dev = resolve_device(device)
    n, n_features = x.shape
    multiclass = p.objective == "multiclass"
    k_out = p.num_class if multiclass else 1

    staged_y = None
    if prebinned is not None:
        if len(prebinned) == 3:
            mapper, d_bins, staged_y = prebinned
        else:
            mapper, d_bins = prebinned
        d_bins = torch.as_tensor(d_bins).to(dev)
    else:
        mapper = binning.fit_bins(x, max_bin=p.max_bin, seed=p.seed)
        d_bins = binning.apply_bins_device(mapper, x, device=dev)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    y_j = (torch.as_tensor(staged_y).to(dev, torch.float32)
           if staged_y is not None else put(y))
    w_j = None if weights is None else put(weights)
    y_onehot = (torch.nn.functional.one_hot(y_j.to(torch.int64), p.num_class)
                .to(torch.float32) if multiclass else None)

    base = 0.0
    if p.boost_from_average and init_scores is None and not multiclass:
        base = obj_mod.init_score(p.objective, y, weights=weights)
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

    has_valid = valid is not None
    if has_valid:
        vx, vy = valid
        v_bins = binning.apply_bins_device(mapper, vx, device=dev)
        vy_j = put(vy)
        v_margin = (torch.zeros((vx.shape[0], p.num_class),
                                dtype=torch.float32, device=dev)
                    if multiclass else
                    torch.full((vx.shape[0],), base, dtype=torch.float32,
                               device=dev))

    cfg = trainer.TreeConfig(
        n_features=n_features, n_bins=p.max_bin + 1, max_depth=p.max_depth,
        num_leaves=p.num_leaves, learning_rate=p.learning_rate,
        lambda_l1=p.lambda_l1, lambda_l2=p.lambda_l2,
        min_gain_to_split=p.min_gain_to_split,
        min_data_in_leaf=p.min_data_in_leaf,
        min_sum_hessian_in_leaf=p.min_sum_hessian_in_leaf)
    fmask = torch.ones(n_features, dtype=torch.bool, device=dev)
    patience = p.early_stopping_round
    track = has_valid and (patience > 0 or p.metric is not None)
    trees, eval_history = [], []
    best_metric, best_iter, rounds_since = None, -1, 0

    for it in range(p.num_iterations):
        grad, hess = _grad_hess(p, margin, y_j, y_onehot)
        if w_j is not None:
            grad = grad * (w_j[:, None] if multiclass else w_j)
            hess = hess * (w_j[:, None] if multiclass else w_j)
        for k in range(k_out):
            gk = grad[:, k] if multiclass else grad
            hk = hess[:, k] if multiclass else hess
            tree, delta = trainer.train_one_tree(d_bins, gk, hk, fmask, cfg)
            trees.append(tree)
            if multiclass:
                margin[:, k] += delta
            else:
                margin = margin + delta
            if has_valid:
                vd = trainer.predict_binned(v_bins, tree.split_feature,
                                            tree.split_bin, tree.leaf_value,
                                            cfg.max_depth)
                if multiclass:
                    v_margin[:, k] += vd
                else:
                    v_margin = v_margin + vd
        if track:
            mv, larger = _device_metric(p.metric, p.objective, v_margin, vy_j)
            mv = float(mv)      # the early-stopping decision needs the host
            eval_history.append(mv)
            if (best_metric is None
                    or ((mv > best_metric) == larger and mv != best_metric)):
                best_metric, best_iter, rounds_since = mv, it, 0
            else:
                rounds_since += 1
                if patience > 0 and rounds_since >= patience:
                    break

    # ONE device->host copy of every tree array
    max_nodes = cfg.max_nodes
    if trees:
        packed = torch.stack([torch.cat([t.split_feature.to(torch.float32),
                                         t.split_bin.to(torch.float32),
                                         t.leaf_value, t.gain, t.cover])
                              for t in trees]).cpu().numpy()
        cols = [packed[:, i * max_nodes:(i + 1) * max_nodes]
                for i in range(5)]
    else:
        cols = [np.zeros((0, max_nodes), np.float32) for _ in range(5)]
    sf, sb, lv, gn, cv = cols
    tree_classes = np.tile(np.arange(k_out, dtype=np.int32),
                           len(trees) // max(k_out, 1))
    booster = _build_booster(
        sf.astype(np.int32), sb.astype(np.int32), lv, tree_classes, mapper, p,
        k_out, n_features, best_iter if (track and patience > 0) else -1,
        gain=gn, cover=cv)
    return booster, base, eval_history
