"""GBDT objectives: gradient/hessian functions and score->output transforms.

Port of `mmlspark_tpu/models/gbdt/objectives.py`: the same closed forms,
elementwise on tensors, and lambdarank over a padded per-group gather
(`make_group_index`, built once per fit on the host).
"""
from __future__ import annotations

import numpy as np
import torch


def binary_grad_hess(scores, y, sigmoid: float = 1.0):
    p = torch.sigmoid(sigmoid * scores)
    grad = sigmoid * (p - y)
    hess = sigmoid * sigmoid * p * (1.0 - p)
    return grad, hess


def l2_grad_hess(scores, y):
    return scores - y, torch.ones_like(scores)


def l1_grad_hess(scores, y):
    return torch.sign(scores - y), torch.ones_like(scores)


def huber_grad_hess(scores, y, alpha: float = 0.9):
    d = scores - y
    grad = torch.where(d.abs() <= alpha, d, alpha * torch.sign(d))
    return grad, torch.ones_like(scores)


def quantile_grad_hess(scores, y, alpha: float = 0.5):
    d = y - scores
    grad = torch.where(d > 0, torch.full_like(d, -alpha),
                       torch.full_like(d, 1.0 - alpha))
    return grad, torch.ones_like(scores)


def poisson_grad_hess(scores, y, max_delta_step: float = 0.7):
    ex = torch.exp(scores)
    return ex - y, ex * float(np.exp(max_delta_step))


def tweedie_grad_hess(scores, y, rho: float = 1.5):
    a, b = torch.exp((1 - rho) * scores), torch.exp((2 - rho) * scores)
    grad = -y * a + b
    hess = -y * (1 - rho) * a + (2 - rho) * b
    return grad, hess


def multiclass_grad_hess(scores, y_onehot):
    """scores (n, K), y_onehot (n, K) -> per-class grad/hess (n, K)."""
    p = torch.softmax(scores, dim=-1)
    grad = p - y_onehot
    k = scores.shape[-1]
    hess = (k / (k - 1.0)) * p * (1.0 - p)
    return grad, hess


def make_group_index(group_ids) -> np.ndarray:
    """Host-side, once per fit: the (n_groups, max_group_size) int32
    row-index matrix, -1 padded, rows of a group in their order in the
    data (the reference's layout, built without its per-row loop)."""
    group_ids = np.asarray(group_ids)
    uniq, inv = np.unique(group_ids, return_inverse=True)
    inv = inv.reshape(-1)
    counts = np.bincount(inv)
    order = np.argsort(inv, kind="stable")
    starts = np.cumsum(counts) - counts
    slot = np.arange(len(order)) - starts[inv[order]]
    out = np.full((len(uniq), int(counts.max())), -1, dtype=np.int32)
    out[inv[order], slot] = order
    return out


def lambdarank_grad_hess(scores, y, group_index, sigmoid: float = 1.0,
                         max_position: int = 0):
    """LambdaRank gradients with NDCG deltas, blocked per group.

    `group_index` is `make_group_index`'s matrix as a tensor on the
    scores' device; pair terms are (n_groups, G, G), so memory scales with
    the largest group, not the dataset. Ranks within a group come from a
    stable sort of the scores (ties keep data order, as `jnp.argsort`).
    max_position > 0 truncates NDCG: a pair counts only if either member
    ranks above the cutoff."""
    n = scores.shape[0]
    valid = group_index >= 0
    idx = group_index.clamp(min=0).to(torch.int64)
    s_fin = torch.where(valid, scores[idx], 0.0)
    s = torch.where(valid, s_fin, -torch.inf)             # (n_groups, G)
    lab = torch.where(valid, y[idx], 0.0)

    # within-group rank by score (padding sorts last)
    order = torch.argsort(-s, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    disc = 1.0 / torch.log2(2.0 + rank.to(torch.float32))
    gain = 2.0 ** lab - 1.0

    pair_valid = (valid[:, :, None] & valid[:, None, :]
                  & (lab[:, :, None] > lab[:, None, :]))    # i beats j
    if max_position > 0:
        in_top = rank < max_position
        pair_valid = pair_valid & (in_top[:, :, None] | in_top[:, None, :])
    delta = ((gain[:, :, None] - gain[:, None, :]).abs()
             * (disc[:, :, None] - disc[:, None, :]).abs())
    rho = torch.sigmoid(-sigmoid * (s_fin[:, :, None] - s_fin[:, None, :]))
    lam = torch.where(pair_valid, -sigmoid * rho * delta, 0.0)
    hpair = torch.where(pair_valid,
                        sigmoid * sigmoid * rho * (1 - rho) * delta, 0.0)

    g_elem = lam.sum(2) - lam.sum(1)                       # (n_groups, G)
    h_elem = hpair.sum(2) + hpair.sum(1)
    flat = torch.where(valid, idx, n).reshape(-1)          # padding -> n
    grad = torch.zeros(n + 1, dtype=scores.dtype, device=scores.device)
    hess = torch.zeros(n + 1, dtype=scores.dtype, device=scores.device)
    grad.index_add_(0, flat, g_elem.reshape(-1))
    hess.index_add_(0, flat, h_elem.reshape(-1))
    return grad[:n], hess[:n].clamp(min=1e-6)


# score -> user-facing output
def binary_transform(scores, sigmoid: float = 1.0):
    return torch.sigmoid(sigmoid * scores)


def softmax_transform(scores):
    return torch.softmax(scores, dim=-1)


def identity_transform(scores):
    return scores


def exp_transform(scores):
    return torch.exp(scores)


OBJECTIVES = {
    "binary": binary_grad_hess,
    "regression": l2_grad_hess,
    "regression_l2": l2_grad_hess,
    "regression_l1": l1_grad_hess,
    "huber": huber_grad_hess,
    "quantile": quantile_grad_hess,
    "poisson": poisson_grad_hess,
    "tweedie": tweedie_grad_hess,
    "multiclass": multiclass_grad_hess,
}


def init_score(objective: str, y, n_classes: int = 1, weights=None):
    """Boost-from-average initial score, matching LightGBM's default.
    Weighted so zero-weight rows don't skew the mean (host numpy, once
    per fit)."""
    y = np.asarray(y, dtype=np.float64)
    w = None if weights is None else np.asarray(weights, dtype=np.float64)
    mean = np.average(y, weights=w) if w is not None else y.mean()
    if objective == "binary":
        p = np.clip(mean, 1e-12, 1 - 1e-12)
        return float(np.log(p / (1 - p)))
    if objective in ("regression", "regression_l2", "huber"):
        return float(mean)
    if objective == "regression_l1" or objective == "quantile":
        return float(np.median(y if w is None else y[w > 0]))
    if objective in ("poisson", "tweedie"):
        return float(np.log(max(mean, 1e-12)))
    return 0.0
