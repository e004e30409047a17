"""AccessAnomaly: collaborative-filtering anomaly detection over
(tenant, user, resource) access logs.

Port of the reference's `cyber/access_anomaly.py` (role: the reference's
mmlspark/cyber/anomaly/collaborative_filtering.py and
complement_access.py). Per tenant, the user x resource matrices are
dense on the model's device (None = the card) and the factorization is
alternating least squares, each half-step one batched ridge solve.

- The matrices: the rows' (user, resource) pairs are aggregated on the
  host (`np.unique` of the pair keys; the counts summed in float64 by
  `np.bincount` in row order, the order of the reference's `np.add.at`),
  and only the observed pairs go to the device. There the ratings are
  scaled into [low, high] in float64 with the reference's operations (a
  division by a device tensor: CUDA divides by a host scalar through its
  reciprocal), and scattered into dense float32 fills of `neg_score` and
  `w_neg = min(factor * |obs| / |neg|, 1)`. After the cast to float32
  both matrices equal the reference's bit for bit.
- The initial factors are the reference's draws, `default_rng(seed)
  .normal(scale=0.1)` for U, then for V, cast to float32.
- ALS: the reference vmaps one ridge solve per entity over
  `fixed * w_row` (n_u x n_r x rank, 8.8 GB at LANL's 12,425 users x
  17,684 computers). Here each side's grams are ONE product, `W @ (F ⊗
  F)` with `F ⊗ F` the (n, rank²) row-wise outer products, and the
  right-hand sides `(W ∘ R) @ F`; then `torch.linalg.solve` over the
  batch of rank x rank systems `gram + reg·I`. The products are f32 with
  TF32 scoped off (`device.exact_f32`), so two fits on one card are
  equal bit for bit; the reference's per-entity products sum in another
  order, so the factors agree within f32 rounding carried through the
  iterations (tests/test_torch_cyber.py states the limits).
- Scoring matches the reference's semantics: likelihood = u . v for the
  (user, resource) pair, standardized per tenant on the training
  history, sign flipped so unlikely accesses score HIGH; unseen users or
  resources, and tenants without evidence, score 0. The model keeps its
  factors on its device: levels are looked up on the host, the gathers
  and dots run on the device, and the column is the reference's float64.

`access_anomaly_from_reference(model)` carries a fitted reference
model's per-tenant levels, factors and statistics into the port's model.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..core import Estimator, Model, Param, Table, Transformer
from ..core.params import in_range
from ..device import exact_f32, resolve_device
from ..ops.levels import lookup_levels


class ComplementAccessTransformer(Transformer):
    """Sample (tenant, user, res) tuples ABSENT from the observed access set
    (reference: cyber/anomaly/complement_access.py): factor x |observed| rows
    per tenant, drawn uniformly from the complement. Host numpy: the
    reference's draws and set logic, so its rows bit for bit."""
    tenant_col = Param("tenant_col", "tenant column", "tenant")
    indexed_user_col = Param("indexed_user_col", "user index column", "user_ix")
    indexed_res_col = Param("indexed_res_col", "resource index column", "res_ix")
    complementset_factor = Param("complementset_factor",
                                 "complement rows per observed row", 2,
                                 validator=in_range(1))
    seed = Param("seed", "sampling seed", 0)

    def _transform(self, t: Table) -> Table:
        rng = np.random.default_rng(self.seed)
        tenants = np.asarray(t[self.tenant_col])
        users = np.asarray(t[self.indexed_user_col], np.int64)
        res = np.asarray(t[self.indexed_res_col], np.int64)
        out_t, out_u, out_r = [], [], []
        for ten in np.unique(tenants):
            m = tenants == ten
            seen = set(zip(users[m].tolist(), res[m].tolist()))
            # ids are 1-based (IdIndexer reserves 0 for unseen): never
            # fabricate complement tuples with the sentinel id
            u_lo = 1 if users[m].min() >= 1 else 0
            r_lo = 1 if res[m].min() >= 1 else 0
            n_users = int(users[m].max()) + 1
            n_res = int(res[m].max()) + 1
            want = self.complementset_factor * int(m.sum())
            cap = (n_users - u_lo) * (n_res - r_lo) - len(seen)
            want = min(want, max(cap, 0))
            got = 0
            while got < want:
                cu = rng.integers(u_lo, n_users, size=want * 2)
                cr = rng.integers(r_lo, n_res, size=want * 2)
                for u, r in zip(cu.tolist(), cr.tolist()):
                    if (u, r) not in seen:
                        seen.add((u, r))
                        out_t.append(ten)
                        out_u.append(u)
                        out_r.append(r)
                        got += 1
                        if got >= want:
                            break
        return Table({self.tenant_col: np.asarray(out_t),
                      self.indexed_user_col: np.asarray(out_u, np.int64),
                      self.indexed_res_col: np.asarray(out_r, np.int64)},
                     t.npartitions)


def pair_sums(u_ix: np.ndarray, r_ix: np.ndarray, counts: np.ndarray,
              n_r: int) -> tuple:
    """(pair keys `u * n_r + r` ascending, their float64 count sums) on
    the host. `np.bincount` adds each key's counts in row order, as the
    reference's `np.add.at` into its dense float64 matrix does."""
    keys = np.asarray(u_ix, np.int64) * n_r + np.asarray(r_ix, np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.bincount(inv.reshape(-1), weights=np.asarray(counts,
                                                           np.float64),
                       minlength=len(uniq))
    return uniq, sums


def tenant_matrices(keys: np.ndarray, sums: np.ndarray, n_u: int, n_r: int,
                    low, high, neg_score, factor,
                    dev: torch.device):
    """(ratings, weights), dense (n_u, n_r) float32 on `dev`, from the
    aggregated pairs; None when no pair has positive evidence. Equal bit
    for bit to the reference's float64 matrices cast to float32."""
    obs = sums > 0
    n_obs = int(obs.sum())
    if n_obs == 0:
        return None
    keys, vals = keys[obs], sums[obs]
    lo, hi = vals.min(), vals.max()
    d_keys = torch.as_tensor(keys, device=dev)
    d_vals = torch.as_tensor(vals, device=dev)
    if hi > lo:
        # the reference's `low + (mat - lo) * (high - low) / (hi - lo)`,
        # one rounding an operation; the divisor is a device tensor
        span = torch.tensor(float(hi - lo), dtype=torch.float64, device=dev)
        scaled = (d_vals - float(lo)) * (high - low) / span + low
    else:
        scaled = torch.full_like(d_vals, float(high))
    cells = n_u * n_r
    ratings = torch.full((cells,), float(np.float32(neg_score)),
                         dtype=torch.float32, device=dev)
    ratings[d_keys] = scaled.to(torch.float32)
    # the complement's soft pull: unobserved cells weigh factor * |obs| /
    # |neg| (the reference's numpy int64 arithmetic), observed cells 1
    n_neg = np.int64(cells - n_obs)
    w_neg = min(factor * np.int64(n_obs) / max(n_neg, 1), 1.0)
    weights = torch.full((cells,), float(np.float32(w_neg)),
                         dtype=torch.float32, device=dev)
    weights[d_keys] = 1.0
    return ratings.view(n_u, n_r), weights.view(n_u, n_r)


def initial_factors(n_u: int, n_r: int, rank: int, seed: int) -> tuple:
    """The reference's starting U and V: `default_rng(seed).normal(
    scale=0.1)` for U, then for V, as float32 host arrays."""
    rng = np.random.default_rng(seed)
    u0 = rng.normal(scale=0.1, size=(n_u, rank)).astype(np.float32)
    v0 = rng.normal(scale=0.1, size=(n_r, rank)).astype(np.float32)
    return u0, v0


def _ridge_side(w: torch.Tensor, wr: torch.Tensor, fixed: torch.Tensor,
                reg_eye: torch.Tensor) -> torch.Tensor:
    """One half-step: for every row i of `w`, solve (Fᵀ diag(w_i) F +
    reg I) x = Fᵀ (w_i ∘ r_i). The grams of all rows are one product of
    `w` with the row-wise outer products of F."""
    n, rank = fixed.shape
    outer = (fixed.unsqueeze(2) * fixed.unsqueeze(1)).reshape(n, rank * rank)
    gram = (w @ outer).view(-1, rank, rank) + reg_eye
    rhs = wr @ fixed
    return torch.linalg.solve(gram, rhs.unsqueeze(-1)).squeeze(-1)


def als(ratings: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
        v: torch.Tensor, iters: int, reg: float) -> tuple:
    """Weighted dense ALS on the matrices' device: `iters` rounds of U
    given V, then V given U (the reference's `_als` scan). f32 products
    with TF32 off."""
    rank = u.shape[1]
    reg_eye = reg * torch.eye(rank, dtype=torch.float32, device=u.device)
    with exact_f32():
        wr = weights * ratings
        for _ in range(iters):
            u = _ridge_side(weights, wr, v, reg_eye)
            v = _ridge_side(weights.t(), wr.t(), u, reg_eye)
    return u, v


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pair_dots(u_vec: torch.Tensor, v_vec: torch.Tensor, u_idx: np.ndarray,
              r_idx: np.ndarray) -> torch.Tensor:
    """float32 u . v of each (user row, resource row) pair, on the
    factors' device. The rank terms are added one at a time in order, so
    a pair's score does not depend on how many pairs share the call (a
    streamed or served row scores as it does in bulk)."""
    dev = u_vec.device
    ui = torch.as_tensor(np.asarray(u_idx, np.int64), device=dev)
    ri = torch.as_tensor(np.asarray(r_idx, np.int64), device=dev)
    prod = u_vec.index_select(0, ui) * v_vec.index_select(0, ri)
    acc = prod[:, 0].clone()
    for k in range(1, prod.shape[1]):
        acc += prod[:, k]
    return acc


class AccessAnomaly(Estimator):
    """Fit per-tenant user/resource latent factors on access history
    (reference: collaborative_filtering.py AccessAnomaly)."""
    tenant_col = Param("tenant_col", "tenant column", "tenant")
    user_col = Param("user_col", "user column", "user")
    res_col = Param("res_col", "resource column", "res")
    likelihood_col = Param("likelihood_col",
                           "optional access-count/likelihood column", None)
    output_col = Param("output_col", "anomaly score column", "anomaly_score")
    rank = Param("rank", "latent dimension", 10, validator=in_range(1))
    max_iter = Param("max_iter", "ALS iterations", 25, validator=in_range(1))
    reg_param = Param("reg_param", "ridge regularization", 1.0)
    low_value = Param("low_value", "rating assigned to rare accesses", 5.0)
    high_value = Param("high_value", "rating for frequent accesses", 10.0)
    complementset_factor = Param("complementset_factor",
                                 "negative samples per observed row", 2)
    neg_score = Param("neg_score", "rating for complement rows", 1.0)
    seed = Param("seed", "random seed", 0)
    device = Param("device", "torch device to fit and score on "
                   "(None = the card)", None)

    def _fit(self, t: Table) -> "AccessAnomalyModel":
        dev = resolve_device(self.device)
        tenants = np.asarray(t[self.tenant_col])
        users = np.asarray(t[self.user_col])
        res = np.asarray(t[self.res_col])
        counts = (np.asarray(t[self.likelihood_col], np.float64)
                  if self.likelihood_col and self.likelihood_col in t
                  else np.ones(len(t)))
        seconds = dict(aggregate=0.0, matrices=0.0, als=0.0, stats=0.0)
        models = {}
        for ten in np.unique(tenants):
            t0 = time.perf_counter()
            m = tenants == ten
            u_levels, u_ix = np.unique(users[m], return_inverse=True)
            r_levels, r_ix = np.unique(res[m], return_inverse=True)
            u_ix, r_ix = u_ix.reshape(-1), r_ix.reshape(-1)
            n_u, n_r = len(u_levels), len(r_levels)
            keys, sums = pair_sums(u_ix, r_ix, counts[m], n_r)
            t1 = time.perf_counter()
            seconds["aggregate"] += t1 - t0
            mats = tenant_matrices(keys, sums, n_u, n_r, self.low_value,
                                   self.high_value, self.neg_score,
                                   self.complementset_factor, dev)
            if mats is None:
                # no positive evidence for this tenant: nothing to
                # factorize; transform scores its rows 0 ("no evidence")
                continue
            ratings, weights = mats
            u0, v0 = initial_factors(n_u, n_r, self.rank, self.seed)
            u0 = torch.as_tensor(u0, device=dev)
            v0 = torch.as_tensor(v0, device=dev)
            _sync(dev)
            t2 = time.perf_counter()
            seconds["matrices"] += t2 - t1
            u_vec, v_vec = als(ratings, weights, u0, v0, self.max_iter,
                               float(self.reg_param))
            del ratings, weights
            _sync(dev)
            t3 = time.perf_counter()
            seconds["als"] += t3 - t2
            # standardization stats of the observed likelihoods, one per
            # row of the history (float64 moments of the f32 dots)
            scores = pair_dots(u_vec, v_vec, u_ix, r_ix).to(torch.float64)
            mean = float(scores.mean())
            std = float(scores.std(correction=0)) or 1.0
            models[str(ten)] = (u_levels, u_vec, r_levels, v_vec, mean, std)
            seconds["stats"] += time.perf_counter() - t3

        m = AccessAnomalyModel(**{p: getattr(self, p) for p in
                                  ("tenant_col", "user_col", "res_col",
                                   "output_col", "device")})
        m._models = models
        m.fit_seconds = seconds
        return m


class AccessAnomalyModel(Model):
    tenant_col = Param("tenant_col", "tenant column", "tenant")
    user_col = Param("user_col", "user column", "user")
    res_col = Param("res_col", "resource column", "res")
    output_col = Param("output_col", "anomaly score column", "anomaly_score")
    device = Param("device", "torch device of the factors (None = the "
                   "card)", None)

    def __init__(self, **kw):
        super().__init__(**kw)
        # tenant -> (user levels, U, resource levels, V, mean, std); U and
        # V are float32 tensors, moved to the model's device once
        self._models = {}
        self._lock = threading.Lock()
        self.fit_seconds = {}

    def _get_state(self):
        out = {"tenants": np.asarray(list(self._models), dtype=object)}
        for i, (ten, (ul, uv, rl, rv, mean, std)) in enumerate(
                self._models.items()):
            out[f"ul_{i}"] = np.asarray(ul)
            out[f"uv_{i}"] = _host_f32(uv)
            out[f"rl_{i}"] = np.asarray(rl)
            out[f"rv_{i}"] = _host_f32(rv)
            out[f"ms_{i}"] = np.asarray([mean, std], np.float64)
        return out

    def _set_state(self, s):
        self._models = {}
        for i, ten in enumerate(np.asarray(s["tenants"])):
            ms = np.asarray(s[f"ms_{i}"])
            self._models[str(ten)] = (
                np.asarray(s[f"ul_{i}"]),
                torch.from_numpy(_host_f32(s[f"uv_{i}"])),
                np.asarray(s[f"rl_{i}"]),
                torch.from_numpy(_host_f32(s[f"rv_{i}"])),
                float(ms[0]), float(ms[1]))

    def _tenant(self, key: str, dev: torch.device):
        """The tenant's entry with its factors on `dev` (moved once;
        serving's partition workers share the model under a lock)."""
        with self._lock:
            ul, uv, rl, rv, mean, std = self._models[key]
            if uv.device != dev or rv.device != dev:
                uv, rv = uv.to(dev), rv.to(dev)
                self._models[key] = (ul, uv, rl, rv, mean, std)
            return ul, uv, rl, rv, mean, std

    def _transform(self, t: Table) -> Table:
        tenants = np.asarray(t[self.tenant_col])
        users = np.asarray(t[self.user_col])
        res = np.asarray(t[self.res_col])
        out = np.zeros(len(t))
        dev = None
        for ten in np.unique(tenants):
            key = str(ten)
            if key not in self._models:
                continue
            if dev is None:
                dev = resolve_device(self.device)
            ul, uv, rl, rv, mean, std = self._tenant(key, dev)
            m = tenants == ten
            u_idx, u_ok = lookup_levels(ul, users[m])
            r_idx, r_ok = lookup_levels(rl, res[m])
            # an unseen value's index is clipped into range: the gather is
            # valid, and the mask scores the row 0
            lik = pair_dots(uv, rv, u_idx, r_idx).cpu().numpy()
            z = (lik - mean) / (std or 1.0)
            score = np.where(u_ok & r_ok, -z, 0.0)  # low likelihood => high
            out[m] = score
        return t.with_column(self.output_col, out)


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, np.float32)


def access_anomaly_from_reference(ref_model, **params) -> AccessAnomalyModel:
    """A port model holding a fitted reference AccessAnomalyModel's
    per-tenant levels, factors and statistics (copied); `params` set the
    port model's Params (e.g. `device`), the reference's columns by
    default."""
    kw = {p: getattr(ref_model, p) for p in
          ("tenant_col", "user_col", "res_col", "output_col")}
    kw.update(params)
    m = AccessAnomalyModel(**kw)
    m._set_state(ref_model._get_state())
    return m
