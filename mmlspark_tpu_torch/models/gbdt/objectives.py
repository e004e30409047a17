"""GBDT objectives: gradient/hessian functions and score->output transforms.

Port of `mmlspark_tpu/models/gbdt/objectives.py`: the same closed forms,
elementwise on tensors. Lambdarank waits for a later slice (ROADMAP
Queue 1 item 10).
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
