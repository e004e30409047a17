"""Batched lasso/least-squares solver for LIME local models.

Port of `mmlspark_tpu/lime/lasso.py` (role: the reference's
LassoUtils.lasso + fitLasso UDF, lime/LassoUtils.scala,
org/apache/spark/ml/LimeNamespaceInjections.scala:11-14). All rows' local
linear models are solved at once on the device, as batched products:

- lambda == 0: centre x and y, then one batched
  `solve(gram + 1e-6 I, corr)` (ridge with a tiny jitter: least squares);
- lambda > 0: ISTA (proximal gradient) with step 1 / trace(gram) for a
  fixed number of iterations, the reference's loop without a
  convergence branch.

Inputs are cast to float32 as the reference casts them; the f32 products
run with TF32 off (`device.exact_f32`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import exact_f32, resolve_device


def _solve_batch(x: torch.Tensor, y: torch.Tensor, lam: float,
                 n_iters: int) -> torch.Tensor:
    """(B, S, D), (B, S) f32 on one device -> (B, D) coefficients."""
    n = x.shape[1]
    xc = x - x.mean(dim=1, keepdim=True)
    yc = y - y.mean(dim=1, keepdim=True)
    xt = xc.transpose(1, 2)
    gram = xt @ xc / n                                    # (B, D, D)
    corr = (xt @ yc.unsqueeze(-1)).squeeze(-1) / n        # (B, D)
    d = gram.shape[-1]
    if lam == 0.0:
        eye = torch.eye(d, dtype=gram.dtype, device=gram.device)
        return torch.linalg.solve(gram + 1e-6 * eye, corr)
    lip = torch.clamp(torch.diagonal(gram, dim1=1, dim2=2).sum(-1),
                      min=1e-6).unsqueeze(-1)             # (B, 1)
    thresh = lam / lip
    w = torch.zeros_like(corr)
    for _ in range(n_iters):
        grad = (gram @ w.unsqueeze(-1)).squeeze(-1) - corr
        w2 = w - grad / lip
        w = torch.sign(w2) * torch.clamp(torch.abs(w2) - thresh, min=0.0)
    return w


def batched_lasso(x: np.ndarray, y: np.ndarray, lam: float,
                  n_iters: int = 200, device=None) -> np.ndarray:
    """Solve argmin_w 0.5/n ||y - x @ w - b||^2 + lam * |w|_1 for a batch,
    on `device` (None = the card).

    x: (B, S, D) design matrices, y: (B, S) targets. Returns (B, D) coefs.
    Intercepts are fit implicitly by centering (standard lasso practice) and
    not returned — parity with fitLasso, which returns only coefficients.
    """
    dev = resolve_device(device)
    xt = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    yt = torch.as_tensor(np.asarray(y, np.float32)).to(dev)
    with exact_f32():
        return _solve_batch(xt, yt, float(lam), n_iters).cpu().numpy()
