"""Port parity: the ranking stages and metrics
(`mmlspark_tpu_torch.recommendation.ranking`).

Each metric, the evaluator, the indexer and the adapter / train-validation
sweep around SAR are fed the same seeded inputs in both packages (JAX on
the CPU, the port's SAR with `device="cpu"`): metrics equal to 1e-12,
indexes and recovered ids equal, the adapter's prediction lists equal
(the port's SAR is built from the reference's fitted tables where the
scores would otherwise differ in the last float32 bits).
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.recommendation import (SAR as RefSAR,
                                         RankingAdapter as RefAdapter,
                                         RankingEvaluator as RefEvaluator,
                                         RankingTrainValidationSplit as RefTVS,
                                         RecommendationIndexer as RefIndexer,
                                         ranking_metrics as ref_metrics)
from mmlspark_tpu_torch.core import PipelineStage, Table
from mmlspark_tpu_torch.recommendation import (
    SAR, RankingAdapter, RankingAdapterModel, RankingEvaluator,
    RankingTrainValidationSplit, RecommendationIndexer, ranking_metrics)

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_TOL = 1e-12


def _lists(seed, n=30, width=8, pool=20):
    rng = np.random.default_rng(seed)
    preds = np.empty(n, dtype=object)
    labels = np.empty(n, dtype=object)
    for i in range(n):
        preds[i] = rng.choice(pool, size=rng.integers(0, width + 1),
                              replace=False)
        labels[i] = rng.choice(pool, size=rng.integers(0, 6), replace=False)
    return preds, labels


@pytest.mark.parametrize("k", [1, 3, 10])
@pytest.mark.parametrize("seed", [0, 1])
def test_ranking_metrics_are_the_reference_s(k, seed):
    preds, labels = _lists(seed)
    got = ranking_metrics(preds, labels, k)
    want = ref_metrics(preds, labels, k)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=_TOL), name


@pytest.mark.parametrize("metric", ["map", "ndcgAt", "precisionAtk",
                                    "recallAtK", "diversityAtK"])
def test_evaluator_is_the_reference_s(metric):
    preds, labels = _lists(2)
    t = {"prediction": preds, "label": labels}
    got = RankingEvaluator(k=5, metric_name=metric).evaluate(Table(t))
    want = RefEvaluator(k=5, metric_name=metric).evaluate(RefTable(t))
    assert got == pytest.approx(want, abs=_TOL)


def _raw_events(seed=0, n=300):
    rng = np.random.default_rng(seed)
    return {"user": np.array([f"u{v}" for v in rng.integers(0, 25, n)],
                             dtype=object),
            "item": np.array([f"i{v}" for v in rng.integers(0, 18, n)],
                             dtype=object)}


def test_indexer_is_the_reference_s(tmp_path):
    raw = _raw_events()
    est = dict(user_output_col="user_ix", item_output_col="item_ix")
    ref = RefIndexer(**est).fit(RefTable(raw))
    port = RecommendationIndexer(**est).fit(Table(raw))
    probe = {"user": np.array(["u3", "nobody", "u0"], dtype=object),
             "item": np.array(["i1", "i2", "zzz"], dtype=object)}
    for col in ("user_ix", "item_ix"):
        np.testing.assert_array_equal(port.transform(Table(probe))[col],
                                      ref.transform(RefTable(probe))[col])
    assert list(port.recover_user([0, 1])) == list(ref.recover_user([0, 1]))
    assert list(port.recover_item([2])) == list(ref.recover_item([2]))
    port.save(str(tmp_path / "ix"))
    back = PipelineStage.load(str(tmp_path / "ix"))
    np.testing.assert_array_equal(back.transform(Table(raw))["user_ix"],
                                  port.transform(Table(raw))["user_ix"])


def _indexed(seed=0):
    raw = _raw_events(seed)
    out = RefIndexer(user_output_col="user", item_output_col="item",
                     user_input_col="user", item_input_col="item").fit(
        RefTable(raw)).transform(RefTable(raw))
    return {"user": np.asarray(out["user"]), "item": np.asarray(out["item"])}


def test_adapter_is_the_reference_s():
    ev = _indexed()
    kw = dict(support_threshold=0, time_col=None, rating_col=None,
              similarity_function="cooccurrence")
    ref = RefAdapter(recommender=RefSAR(**kw), k=3).fit(RefTable(ev))
    port = RankingAdapter(recommender=SAR(device="cpu", **kw), k=3).fit(
        Table(ev))
    assert isinstance(port, RankingAdapterModel)
    got = port.transform(Table(ev))
    want = ref.transform(RefTable(ev))
    np.testing.assert_array_equal(got["user"], want["user"])
    # co-occurrence scores are integer sums: exact, so the lists match
    for a, b in zip(got["prediction"], want["prediction"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["label"], want["label"]):
        np.testing.assert_array_equal(a, b)
    ev_kw = dict(k=3, metric_name="recallAtK")
    assert RankingEvaluator(**ev_kw).evaluate(got) == pytest.approx(
        RefEvaluator(**ev_kw).evaluate(want), abs=_TOL)


def test_adapter_answers_a_user_the_fit_never_saw():
    """A validation user outside the train split's id range answers the
    recommender's unknown-user row (items -1), which ranks no label, and
    the known users keep their lists."""
    ev = _indexed()
    kw = dict(support_threshold=0, time_col=None, rating_col=None,
              similarity_function="cooccurrence")
    port = RankingAdapter(recommender=SAR(device="cpu", **kw), k=3).fit(
        Table(ev))
    new_user = int(np.max(ev["user"])) + 5
    val = {c: np.concatenate([np.asarray(v), np.asarray(v)[:2]])
           for c, v in ev.items()}
    val["user"][-2:] = new_user
    got = port.transform(Table(val))
    known = port.transform(Table(ev))
    assert got["user"][-1] == new_user
    np.testing.assert_array_equal(got["prediction"][-1], [-1, -1, -1])
    for a, b in zip(got["prediction"][:-1], known["prediction"]):
        np.testing.assert_array_equal(a, b)
    recall = RankingEvaluator(k=3, metric_name="recallAtK").evaluate(got)
    assert 0.0 <= recall <= 1.0


def test_train_validation_split_is_the_reference_s(tmp_path):
    ev = _indexed(1)
    common = dict(param_maps=[{"similarity_function": "cooccurrence"},
                              {"support_threshold": 3}],
                  train_ratio=0.75, user_col="user", item_col="item",
                  label_col="label", seed=3, min_ratings_u=2)
    kw = dict(time_col=None, rating_col=None, support_threshold=0,
              similarity_function="cooccurrence")
    ref = RefTVS(estimator=RefSAR(**kw),
                 evaluator=RefEvaluator(k=3, metric_name="recallAtK"),
                 **common).fit(RefTable(ev))
    port = RankingTrainValidationSplit(
        estimator=SAR(device="cpu", **kw),
        evaluator=RankingEvaluator(k=3, metric_name="recallAtK"),
        **common).fit(Table(ev))
    np.testing.assert_allclose(port.validation_metrics,
                               ref.validation_metrics, atol=_TOL)
    assert port.best_index == ref.best_index
    # the filters and the per-user split are the reference's row for row
    est = RankingTrainValidationSplit(estimator=None, **common)
    ref_est = RefTVS(estimator=None, **common)
    tr, va = est._split(est._filter_ratings(Table(ev)))
    rtr, rva = ref_est._split(ref_est._filter_ratings(RefTable(ev)))
    np.testing.assert_array_equal(tr["item"], rtr["item"])
    np.testing.assert_array_equal(va["user"], rva["user"])
    out = port.transform(Table(ev))
    assert "prediction" in out.columns
    port.save(str(tmp_path / "tvs"))
    back = PipelineStage.load(str(tmp_path / "tvs"))
    assert back.best_index == port.best_index
    for a, b in zip(back.transform(Table(ev))["prediction"],
                    out["prediction"]):
        np.testing.assert_array_equal(a, b)
