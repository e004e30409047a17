"""Ranking evaluation + the indexer/adapter stages around recommenders.

Port of the reference's `recommendation/ranking.py`, host numpy (role:
the reference's recommendation/RankingEvaluator.scala
(AdvancedRankingMetrics:20-100), RecommendationIndexer.scala and
RankingAdapter.scala). Metric definitions follow Spark's RankingMetrics —
binary relevance MAP / NDCG@k / precision@k — plus the reference's added
recallAtK (RankingEvaluator.scala:29-35). All metrics are computed
vectorized over the (n, k) prediction matrix.
"""
from __future__ import annotations

import numpy as np

from ..core import Estimator, Model, Param, Table
from ..core.params import HasLabelCol, HasPredictionCol, in_range, one_of
from ..core.pipeline import Evaluator


def _hits_matrix(preds, labels):
    """(n, k) bool: preds[i, j] in labels[i]."""
    n = len(preds)
    k = max((len(np.atleast_1d(p)) for p in preds), default=0)
    hits = np.zeros((n, k), bool)
    sizes = np.zeros(n, np.int64)
    for i in range(n):
        lab = set(np.atleast_1d(labels[i]).tolist())
        sizes[i] = len(lab)
        p = np.atleast_1d(preds[i])
        hits[i, :len(p)] = [v in lab for v in p.tolist()]
    return hits, sizes


def ranking_metrics(preds, labels, k: int) -> dict:
    """MAP, ndcgAt, precisionAtk, recallAtK, diversityAtK — the reference's
    AdvancedRankingMetrics surface (RankingEvaluator.scala:20-45)."""
    hits, sizes = _hits_matrix(preds, labels)
    n, width = hits.shape
    kk = min(k, width) if width else 0
    ranks = np.arange(1, width + 1)

    with np.errstate(divide="ignore", invalid="ignore"):
        # MAP over the full prediction list (Spark meanAveragePrecision)
        cum_hits = np.cumsum(hits, axis=1)
        prec_at_rank = cum_hits / ranks
        ap = (prec_at_rank * hits).sum(axis=1) / np.maximum(sizes, 1)
        # NDCG@k, binary gains
        dcg = (hits[:, :kk] / np.log2(ranks[:kk] + 1)).sum(axis=1)
        # ideal DCG length is min(|labels|, k) — Spark's RankingMetrics
        # ndcgAt semantics. Clipping to the widest PREDICTION list
        # instead would understate the ideal and inflate NDCG whenever a
        # recommender returns fewer than k items.
        ideal_len = np.minimum(sizes, k)
        max_len = int(ideal_len.max()) if n else 0
        igains = 1.0 / np.log2(np.arange(1, max_len + 1) + 1) if max_len else \
            np.zeros(0)
        idcg = np.array([igains[:m].sum() for m in ideal_len])
        ndcg = np.where(idcg > 0, dcg / np.maximum(idcg, 1e-12), 0.0)
        # Spark's precisionAt always divides by k, even when fewer than k
        # predictions exist (RankingMetrics semantics)
        prec_k = hits[:, :kk].sum(axis=1) / max(k, 1)
        recall_k = hits[:, :kk].sum(axis=1) / np.maximum(sizes, 1)

    all_pred = set()
    all_lab = set()
    for i in range(n):
        all_pred |= set(np.atleast_1d(preds[i]).tolist()[:k])
        all_lab |= set(np.atleast_1d(labels[i]).tolist())
    diversity = len(all_pred) / max(len(all_lab), 1)

    return {"map": float(np.mean(ap)) if n else 0.0,
            "ndcgAt": float(np.mean(ndcg)) if n else 0.0,
            "precisionAtk": float(np.mean(prec_k)) if n else 0.0,
            "recallAtK": float(np.mean(recall_k)) if n else 0.0,
            "diversityAtK": float(diversity)}


class RankingEvaluator(Evaluator, HasLabelCol, HasPredictionCol):
    """Evaluator over per-row prediction/label id collections (reference:
    RankingEvaluator.scala:102-152)."""
    k = Param("k", "cutoff", 10, validator=in_range(1))
    metric_name = Param("metric_name", "which metric evaluate() returns",
                        "ndcgAt",
                        validator=one_of("map", "ndcgAt", "precisionAtk",
                                         "recallAtK", "diversityAtK"))
    label_col = Param("label_col", "true item-id collection column", "label")
    prediction_col = Param("prediction_col",
                           "predicted item-id collection column", "prediction")

    def get_metrics_map(self, t: Table) -> dict:
        return ranking_metrics(t[self.prediction_col], t[self.label_col],
                               self.k)

    def evaluate(self, t: Table) -> float:
        return self.get_metrics_map(t)[self.metric_name]


class RecommendationIndexer(Estimator):
    """String user/item ids -> dense int ids and back (reference:
    recommendation/RecommendationIndexer.scala)."""
    user_input_col = Param("user_input_col", "raw user column", "user")
    user_output_col = Param("user_output_col", "indexed user column", "user_ix")
    item_input_col = Param("item_input_col", "raw item column", "item")
    item_output_col = Param("item_output_col", "indexed item column", "item_ix")
    rating_col = Param("rating_col", "passthrough rating column", None)

    def _fit(self, t: Table) -> "RecommendationIndexerModel":
        m = RecommendationIndexerModel(**{p: getattr(self, p) for p in (
            "user_input_col", "user_output_col", "item_input_col",
            "item_output_col", "rating_col")})
        m._user_levels = np.unique(t[self.user_input_col])
        m._item_levels = np.unique(t[self.item_input_col])
        return m


class RecommendationIndexerModel(Model):
    user_input_col = Param("user_input_col", "raw user column", "user")
    user_output_col = Param("user_output_col", "indexed user column", "user_ix")
    item_input_col = Param("item_input_col", "raw item column", "item")
    item_output_col = Param("item_output_col", "indexed item column", "item_ix")
    rating_col = Param("rating_col", "passthrough rating column", None)

    def __init__(self, **kw):
        super().__init__(**kw)
        self._user_levels = None
        self._item_levels = None

    def _get_state(self):
        return {"user_levels": np.asarray(self._user_levels),
                "item_levels": np.asarray(self._item_levels)}

    def _set_state(self, s):
        self._user_levels = np.asarray(s["user_levels"])
        self._item_levels = np.asarray(s["item_levels"])

    def _index(self, col, levels):
        idx = np.searchsorted(levels, col)
        idx = np.clip(idx, 0, len(levels) - 1)
        return np.where(levels[idx] == col, idx, -1).astype(np.int64)

    def _transform(self, t: Table) -> Table:
        return t.with_columns({
            self.user_output_col: self._index(t[self.user_input_col],
                                              self._user_levels),
            self.item_output_col: self._index(t[self.item_input_col],
                                              self._item_levels)})

    def recover_user(self, ids):
        return self._user_levels[np.asarray(ids, np.int64)]

    def recover_item(self, ids):
        return self._item_levels[np.asarray(ids, np.int64)]


class RankingAdapter(Estimator, HasLabelCol):
    """Fits a recommender and emits per-user (prediction, label) id lists the
    RankingEvaluator consumes (reference: recommendation/RankingAdapter.scala)."""
    recommender = Param("recommender", "estimator producing a recommender "
                        "model with recommend_for_user_subset", None)
    k = Param("k", "recommendations per user", 10, validator=in_range(1))
    user_col = Param("user_col", "user id column", "user")
    item_col = Param("item_col", "item id column", "item")

    def _fit(self, t: Table) -> "RankingAdapterModel":
        if self.recommender is None:
            raise ValueError("RankingAdapter: recommender param is not set")
        model = self.recommender.fit(t)
        m = RankingAdapterModel(**{p: getattr(self, p) for p in (
            "k", "user_col", "item_col", "label_col")})
        m.set(recommender_model=model)
        return m


class RankingAdapterModel(Model, HasLabelCol):
    recommender_model = Param("recommender_model", "fitted recommender", None)
    k = Param("k", "recommendations per user", 10)
    user_col = Param("user_col", "user id column", "user")
    item_col = Param("item_col", "item id column", "item")

    def _transform(self, t: Table) -> Table:
        users = np.asarray(t[self.user_col], np.int64)
        items = np.asarray(t[self.item_col], np.int64)
        uniq = np.unique(users)
        recs = self.recommender_model.recommend_for_user_subset(uniq, self.k)
        rec_items = np.asarray(recs["recommendations"])
        preds = np.empty(len(uniq), dtype=object)
        labels = np.empty(len(uniq), dtype=object)
        for i, u in enumerate(uniq):
            preds[i] = rec_items[i]
            labels[i] = items[users == u]
        return Table({self.user_col: uniq, "prediction": preds,
                      self.label_col: labels})


class RankingTrainValidationSplit(Estimator, HasLabelCol):
    """Per-user stratified train/validation split + param-map sweep over a
    recommender, scored with RankingEvaluator (reference:
    recommendation/RankingTrainValidationSplit.scala:25-200 — stratified
    splitDF, minRatingsU/I filters, thread-pool sweep, best model kept)."""
    estimator = Param("estimator", "recommender to sweep", None)
    param_maps = Param("param_maps", "list of {param: value} overrides", None)
    evaluator = Param("evaluator", "RankingEvaluator (defaults to ndcgAt)",
                      None)
    train_ratio = Param("train_ratio", "per-user train fraction", 0.75)
    user_col = Param("user_col", "user id column", "user")
    item_col = Param("item_col", "item id column", "item")
    min_ratings_u = Param("min_ratings_u",
                          "drop users with fewer ratings", 1,
                          validator=in_range(1))
    min_ratings_i = Param("min_ratings_i",
                          "drop items with fewer ratings", 1,
                          validator=in_range(1))
    parallelism = Param("parallelism", "concurrent candidate fits", 1,
                        validator=in_range(1))
    seed = Param("seed", "split shuffle seed", 0)

    def _filter_ratings(self, t: Table) -> Table:
        users = np.asarray(t[self.user_col])
        items = np.asarray(t[self.item_col])
        while True:  # filters interact: iterate to the fixpoint (each round
            # either drops rows or terminates, so this is bounded by len(t))
            u_vals, u_cnt = np.unique(users, return_counts=True)
            i_vals, i_cnt = np.unique(items, return_counts=True)
            keep_u = np.isin(users, u_vals[u_cnt >= self.min_ratings_u])
            keep_i = np.isin(items, i_vals[i_cnt >= self.min_ratings_i])
            keep = keep_u & keep_i
            if keep.all():
                return t
            t = t.filter(keep)
            users, items = users[keep], items[keep]

    def _split(self, t: Table):
        """Per-user stratified split: each user keeps ceil(ratio * n_u) rows
        in train (never 0), the rest validate (reference splitDF)."""
        users = np.asarray(t[self.user_col])
        rng = np.random.default_rng(self.seed)
        in_train = np.zeros(len(users), bool)
        for u in np.unique(users):
            rows = np.flatnonzero(users == u)
            rng.shuffle(rows)
            n_train = max(int(np.ceil(self.train_ratio * len(rows))), 1)
            in_train[rows[:n_train]] = True
        return t.filter(in_train), t.filter(~in_train)

    def _fit(self, t: Table) -> "RankingTrainValidationSplitModel":
        if self.estimator is None:
            raise ValueError(
                "RankingTrainValidationSplit: estimator param is not set")
        ev = self.evaluator or RankingEvaluator(label_col=self.label_col)
        train, valid = self._split(self._filter_ratings(t))
        maps = list(self.param_maps or [{}])

        def run(pm):
            est = self.estimator.copy(pm)
            adapter = RankingAdapter(recommender=est, k=ev.k,
                                     user_col=self.user_col,
                                     item_col=self.item_col,
                                     label_col=self.label_col)
            fitted = adapter.fit(train)
            return fitted, ev.evaluate(fitted.transform(valid))

        if self.parallelism > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=self.parallelism) as pool:
                results = list(pool.map(run, maps))
        else:
            results = [run(pm) for pm in maps]

        metrics = np.asarray([m for _, m in results], np.float64)
        larger = getattr(ev, "is_larger_better", True)
        best = int(np.argmax(metrics if larger else -metrics))
        model = RankingTrainValidationSplitModel(
            **{p: getattr(self, p) for p in ("user_col", "item_col",
                                             "label_col")})
        model.set(best_adapter=results[best][0],
                  validation_metrics=[float(m) for _, m in results],
                  best_index=best)
        return model


class RankingTrainValidationSplitModel(Model, HasLabelCol):
    """Best fitted adapter (a complex stage Param, so save/load round-trips
    it like any nested model) + the sweep's validation metrics."""
    user_col = Param("user_col", "user id column", "user")
    item_col = Param("item_col", "item id column", "item")
    best_adapter = Param("best_adapter", "best fitted RankingAdapterModel",
                         None)
    validation_metrics = Param("validation_metrics",
                               "metric per swept param map", None)
    best_index = Param("best_index", "winning param-map index", -1)

    @property
    def best_model(self):
        return self.best_adapter.recommender_model

    def _transform(self, t: Table) -> Table:
        return self.best_adapter.transform(t)
