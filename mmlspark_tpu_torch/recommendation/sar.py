"""SAR (Smart Adaptive Recommendations) recommender.

Port of the reference's `recommendation/sar.py` (role: the reference's
recommendation/SAR.scala:36-209 + SARModel.scala:22-170). The user-item
affinity matrix A (U x I) and the item-item similarity S (I x I) are
built on the model's device (None = the card), and ONE product scores
every user against every item, followed by the reference's top-k.

Semantics matched:
- affinity = sum over events of rating * 2^(-dt / (time_decay_coeff
  days)), with the four time/rating presence cases of
  SAR.calculateUserItemAffinities (SAR.scala:86-118);
- similarity = co-occurrence counts (distinct users per item pair) with
  support_threshold, optionally normalized to jaccard (default) or lift
  (SAR.calculateItemItemSimilarity, SAR.scala:155-208).

Deterministic on the card: the affinity's per-(user, item) sums are
one segmented reduction over the stably sorted events
(`torch.segment_reduce`, no atomics), in float64, rounded to float32
once, so two fits are equal bit for bit on either device and within
float32 rounding of the reference's float32 sums. C = BᵀB runs as f32
under `device.exact_f32`; its counts stay below 2^24 and are exact.
Scores are A @ S with float64 accumulation rounded once to float32, so
an answer does not depend on how the product is split (the serving
plan's mesh positions, `workloads/sar_serving.py`); top-k breaks ties by
the lower index, as `lax.top_k` does (`ops.topk.top_k`).

`sar_from_reference(model)` carries a fitted reference model's affinity
and similarity into the port's model.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..core import Estimator, Model, Param, Table
from ..core.params import in_range, one_of
from ..device import exact_f32, resolve_device
from ..ops.topk import top_k


class _SARParams:
    user_col = Param("user_col", "user id column (int ids)", "user")
    item_col = Param("item_col", "item id column (int ids)", "item")
    rating_col = Param("rating_col", "optional rating column", "rating")
    time_col = Param("time_col", "optional epoch-seconds activity column",
                     "timestamp")
    similarity_function = Param("similarity_function",
                                "jaccard | lift | cooccurrence", "jaccard",
                                validator=one_of("jaccard", "lift",
                                                 "cooccurrence"))
    support_threshold = Param("support_threshold",
                              "min co-occurrence to count", 4,
                              validator=in_range(0))
    time_decay_coeff = Param("time_decay_coeff",
                             "half-life of the affinity decay, in days", 30)
    start_time = Param("start_time",
                       "epoch-seconds reference time for decay; default = "
                       "max activity time in the data", None)
    device = Param("device", "torch device to fit and score on "
                   "(None = the card)", None)


def _segment_sums(keys: torch.Tensor, weights: torch.Tensor) -> tuple:
    """(unique keys ascending, float64 sums of their weights): a stable
    sort groups the keys and one segmented reduction sums each group, in
    one pass however often a key repeats. The CPU sums each group in the
    events' input order; the card's reduction uses no atomics, and two
    card fits of a log whose pairs repeat ~1e5 times are equal bit for
    bit (`chip_smoke.py` [fleet] (b))."""
    if keys.numel() == 0:
        return keys, torch.zeros(0, dtype=torch.float64, device=keys.device)
    order = torch.sort(keys, stable=True).indices
    uniq, counts = torch.unique_consecutive(keys[order], return_counts=True)
    return uniq, torch.segment_reduce(weights[order], "sum", lengths=counts)


def _sar_tables(users: np.ndarray, items: np.ndarray,
                weights: np.ndarray, n_users: int, n_items: int,
                similarity_function: str, support_threshold,
                dev: torch.device) -> tuple:
    """(affinity (U, I) f32, similarity (I, I) f32) on `dev` from the
    events and their float64 weights."""
    u = torch.as_tensor(users, device=dev)
    it = torch.as_tensor(items, device=dev)
    keys, sums = _segment_sums(u * n_items + it,
                               torch.as_tensor(weights, device=dev))
    affinity = torch.zeros(n_users * n_items, dtype=torch.float32,
                           device=dev)
    affinity[keys] = sums.to(torch.float32)
    # binary distinct user-item interactions -> C = B^T B
    b = torch.zeros(n_users * n_items, dtype=torch.float32, device=dev)
    b[keys] = 1.0
    b = b.reshape(n_users, n_items)
    with exact_f32():
        cooc = b.t() @ b                                  # (I, I)
    occ = torch.diagonal(cooc).clone()
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    sim = torch.where(cooc >= support_threshold, cooc, zero)
    if similarity_function == "jaccard":
        denom = occ[:, None] + occ[None, :] - cooc
        sim = torch.where(denom > 0, sim / torch.clamp(denom, min=1e-12),
                          zero)
    elif similarity_function == "lift":
        denom = occ[:, None] * occ[None, :]
        sim = torch.where(denom > 0, sim / torch.clamp(denom, min=1e-12),
                          zero)
    return affinity.reshape(n_users, n_items), sim


def _event_weights(est, t: Table) -> np.ndarray:
    """Per-event float64 weights: rating (or 1) times the time decay
    2^(-(ref - t) / half_life) when the table has a time column."""
    have_time = est.time_col is not None and est.time_col in t
    have_rating = est.rating_col is not None and est.rating_col in t
    weights = np.ones(len(t), np.float64)
    if have_rating:
        weights = np.asarray(t[est.rating_col], np.float64).copy()
    if have_time:
        ts = np.asarray(t[est.time_col], np.float64)
        ref = float(est.start_time) if est.start_time is not None \
            else float(ts.max())
        half_life_s = est.time_decay_coeff * 24.0 * 3600.0
        weights = weights * np.power(2.0, -(ref - ts) / half_life_s)
    return weights


def _fit_events(est, t: Table, what: str) -> tuple:
    """(affinity, similarity) as host float32 arrays, built on the
    estimator's device."""
    users = np.asarray(t[est.user_col], np.int64)
    items = np.asarray(t[est.item_col], np.int64)
    if users.min() < 0 or items.min() < 0:
        raise ValueError(f"{what} expects non-negative integer user/item "
                         "ids (run RecommendationIndexer first)")
    n_users = int(users.max()) + 1
    n_items = int(items.max()) + 1
    dev = resolve_device(est.device)
    aff, sim = _sar_tables(users, items, _event_weights(est, t), n_users,
                           n_items, est.similarity_function,
                           est.support_threshold, dev)
    return aff.cpu().numpy(), sim.cpu().numpy()


class SAR(Estimator, _SARParams):
    def _fit(self, t: Table) -> "SARModel":
        affinity, sim = _fit_events(self, t, "SAR")
        m = SARModel(**{p: getattr(self, p) for p in (
            "user_col", "item_col", "rating_col", "similarity_function",
            "support_threshold", "device")})
        m._affinity = affinity
        m._similarity = sim
        return m


def _scores64(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """a @ s with float64 accumulation (float32 inputs widened: every
    product is exact), still float64."""
    return a.to(torch.float64) @ s.to(torch.float64)


class SARModel(Model, _SARParams):
    """Scores = affinity @ similarity, one product for all users on the
    model's device (reference: SARModel.recommendForAll,
    SARModel.scala:100-170)."""
    prediction_col = Param("prediction_col", "predicted score column",
                           "prediction")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._affinity = None
        self._similarity = None
        self._bound = None            # (device, affinity, similarity)
        self._bound_lock = threading.Lock()

    def _get_state(self):
        return {"affinity": self._affinity, "similarity": self._similarity}

    def _set_state(self, s):
        self._affinity = np.asarray(s["affinity"])
        self._similarity = np.asarray(s["similarity"])
        self._bound = None

    @property
    def n_users(self):
        return self._affinity.shape[0]

    @property
    def n_items(self):
        return self._affinity.shape[1]

    def _tables(self, dev: torch.device) -> tuple:
        """(affinity, similarity) float32 on `dev`, moved once per device;
        serving's partition workers share them under a lock."""
        with self._bound_lock:
            if self._bound is None or self._bound[0] != dev:
                self._bound = (dev, torch.as_tensor(
                    np.ascontiguousarray(self._affinity, np.float32),
                    device=dev), torch.as_tensor(np.ascontiguousarray(
                        self._similarity, np.float32), device=dev))
            return self._bound[1:]

    def _known(self, user_ids) -> tuple:
        """(int64 ids, mask of the ids inside the fitted user range)."""
        ids = np.asarray(user_ids, np.int64)
        return ids, (ids >= 0) & (ids < self.n_users)

    def _scores(self, user_ids: np.ndarray) -> torch.Tensor:
        """(n, I) float32 scores of `user_ids` on the model's device. The
        ids must lie in the fitted range: an index outside it would stop
        the card's gather with a device-side assert."""
        ids, known = self._known(user_ids)
        if not known.all():
            raise ValueError(f"user ids outside [0, {self.n_users}) "
                             "have no affinity row")
        dev = resolve_device(self.device)
        aff, sim = self._tables(dev)
        rows = aff.index_select(0, torch.as_tensor(ids, device=dev))
        return _scores64(rows, sim).to(torch.float32)

    def recommend_for_all_users(self, num_items: int,
                                remove_seen: bool = False) -> Table:
        return self.recommend_for_user_subset(
            np.arange(self.n_users), num_items, remove_seen)

    def recommend_for_user_subset(self, user_ids, num_items: int,
                                  remove_seen: bool = False) -> Table:
        """Top num_items per user as (user, (k,) item ids, (k,) ratings) —
        the columnar analogue of the reference's array<struct> output
        (SARModel.scala:47-55). Ties rank the lower item id first. Ids
        outside the fitted user range (a user the fit never saw) answer
        items -1 and ratings NaN, as the serving plan does."""
        user_ids, known = self._known(user_ids)
        rows = np.where(known, user_ids, 0)
        scores = self._scores(rows)
        if remove_seen:
            seen = self._tables(scores.device)[0].index_select(
                0, torch.as_tensor(rows, device=scores.device)) > 0
            scores = scores.masked_fill(seen, float("-inf"))
        # a catalog smaller than the requested k returns every item, like
        # the reference's recommendForAllUsers on a tiny item set
        vals, idx = top_k(scores, min(num_items, scores.shape[-1]))
        idx = idx.cpu().numpy()
        vals = vals.cpu().numpy().astype(np.float64)
        idx[~known] = -1
        vals[~known] = np.nan
        return Table({self.user_col: user_ids, "recommendations": idx,
                      "ratings": vals})

    def _transform(self, t: Table) -> Table:
        """Predict the (user, item) pair scores present in the table
        (reference: BaseRecommendationModel.transform path used by
        RankingAdapter). Ids outside the fitted range — including the -1
        RecommendationIndexerModel emits for unseen values — score NaN,
        matching Spark ALS's coldStartStrategy='nan' rather than silently
        scoring a wrong user/item."""
        users, known = self._known(t[self.user_col])
        items = np.asarray(t[self.item_col], np.int64)
        known &= (items >= 0) & (items < self.n_items)
        uniq, inv = np.unique(np.where(known, users, 0), return_inverse=True)
        scores = self._scores(uniq).cpu().numpy()
        pred = scores[inv, np.where(known, items, 0)].astype(np.float64)
        return t.with_column(self.prediction_col,
                             np.where(known, pred, np.nan))


def sar_from_reference(ref_model, cls=None, **params):
    """A port model holding a fitted reference SAR model's affinity and
    similarity (numpy arrays, copied). `cls` (default `SARModel`) picks
    the port class; `params` set its Params (e.g. `device`)."""
    m = (SARModel if cls is None else cls)(**params)
    m._set_state({"affinity": np.array(ref_model._affinity, np.float32),
                  "similarity": np.array(ref_model._similarity,
                                         np.float32)})
    return m
