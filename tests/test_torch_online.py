"""Port parity: continuous learning (`online/`: `LabelFeed`,
`OnlineLearner`, `ContinuousLearner`) with the control plane it drives.

The cases of the reference's `tests/test_online.py`, against the port on
the CPU (`device="cpu"` on every fit and learner): the label feed's
bounds and replay, the learner's bucket discipline and snapshot
exactness, the pure policy machine, the `online.refit` chaos site (a
retried refit reaches the clean run's weights exactly), the rollback of
a poisoned candidate over a port `ServingTransform`, the self-healing
shift on a live server, and the floor burn read from the SLO engine's
window. Parity: one `_online_update` step against the reference's on the
same arrays, weights within `_STEP_RTOL` of the reference's largest (the
port reuses the batch learner's step, which divides by the AdaGrad root
before scaling by lr; the reference scales first), and a learner fed
the same chunks in both packages within `_CHUNKS_RTOL`.
"""
import functools
import json
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.vw.learner import VWParams as RefVWParams
from mmlspark_tpu.online import OnlineLearner as RefOnlineLearner
from mmlspark_tpu.online.learner import _online_update as ref_update
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.models.vw.learner import VWParams
from mmlspark_tpu_torch.online import (ContinuousLearner,
                                       ContinuousLearnerMachine, LabelFeed,
                                       OnlineAction, OnlineConfig,
                                       OnlineLearner, OnlineObservation)
from mmlspark_tpu_torch.online import learner as olearner
from mmlspark_tpu_torch.online import loop as ol
from mmlspark_tpu_torch.reliability.faults import FaultInjector
from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
from mmlspark_tpu_torch.telemetry import lineage as tlineage
from mmlspark_tpu_torch.telemetry import names as tnames
from mmlspark_tpu_torch.telemetry import perf
from mmlspark_tpu_torch.telemetry import quality as Q

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_STEP_RTOL = 1e-6
_CHUNKS_RTOL = 1e-5


@pytest.fixture
def online_state():
    reliability_metrics.reset()
    Q.reset_monitor()
    tlineage.reset_version_registry()
    tlineage.configure_run_ledger(None)
    perf.get_compile_log().clear()
    yield
    perf.get_compile_log().clear()
    tlineage.configure_run_ledger(None)
    tlineage.reset_version_registry()
    Q.reset_monitor()
    reliability_metrics.reset()


def _pairs(seed=0, n=256, k=8, bits=12):
    """Synthetic hashed sparse pairs over fixed slots + a linear truth."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, 1 << bits, size=k).astype(np.int32)
    idx = np.tile(slots, (n, 1))
    val = rng.normal(size=(n, k)).astype(np.float32)
    beta = rng.normal(size=k).astype(np.float32)
    y = (val @ beta > 0).astype(np.float32)
    return idx, val, y, beta


@functools.lru_cache(maxsize=None)
def _fit_vw(seed=0, n=512, k=8, bits=12):
    """One fitted sparse-pair incumbent (cached: read-only everywhere)."""
    from mmlspark_tpu_torch.models.vw.estimators import \
        VowpalWabbitClassifier
    idx, val, y, beta = _pairs(seed=seed, n=n, k=k, bits=bits)
    model = VowpalWabbitClassifier(
        features_col="features", label_col="label", num_bits=bits,
        num_passes=4, num_tasks=1, device="cpu").fit(
            Table({"features_idx": idx, "features_val": val, "label": y}))
    return model, idx, val, y, beta


# ------------------------------------------------ parity of the step
def test_online_update_step_matches_reference():
    rng = np.random.default_rng(1)
    dim, rows, k = 1 << 10, 64, 8
    idx = rng.integers(0, 1 << 14, size=(rows, k)).astype(np.int32)
    val = rng.normal(size=(rows, k)).astype(np.float32)
    y = rng.integers(0, 2, rows).astype(np.float32)
    w = np.ones(rows, np.float32)
    w[-5:] = 0.0                                   # padded rows
    weights = (rng.normal(size=dim) * 0.1).astype(np.float32)
    acc = np.abs(rng.normal(size=dim)).astype(np.float32)
    for loss in ("logistic", "squared"):
        want = ref_update(idx, val, y, w, weights, np.float32(0.3), acc,
                          np.float32(0.5), np.float32(1e-3),
                          loss_function=loss)
        got = olearner._online_update(
            *(torch.as_tensor(a) for a in (idx, val, y, w, weights)),
            torch.tensor(0.3), torch.as_tensor(acc), np.float32(0.5),
            np.float32(1e-3), loss_function=loss)
        scale = float(np.abs(np.asarray(want[0])).max())
        assert np.abs(got[0].numpy() - np.asarray(want[0])).max() \
            <= _STEP_RTOL * scale, loss
        assert abs(float(got[1]) - float(want[1])) <= _STEP_RTOL
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=_STEP_RTOL)
        assert abs(float(got[3]) - float(want[3])) \
            <= _STEP_RTOL * abs(float(want[3]))


def test_learner_chunks_match_reference(online_state):
    idx, val, y, _ = _pairs(seed=3, n=300, k=6)
    kw = dict(loss_function="logistic", num_bits=12, learning_rate=0.5)
    ref = RefOnlineLearner(RefVWParams(**kw), rows=64)
    lrn = OnlineLearner(VWParams(**kw), rows=64, device="cpu")
    for _ in range(3):
        want = ref.partial_fit(idx, val, y)
        got = lrn.partial_fit(idx, val, y)
        assert got["updates"] == want["updates"]
        assert abs(got["loss"] - want["loss"]) <= 1e-5 * want["loss"]
    snap = lrn.snapshot()
    scale = float(np.abs(ref._weights).max())
    assert np.abs(snap["weights"] - ref._weights).max() \
        <= _CHUNKS_RTOL * scale
    np.testing.assert_allclose(snap["acc"], ref._acc, rtol=_CHUNKS_RTOL)
    assert lrn.k == ref.k == 8


def test_contract_names_its_item():
    with pytest.raises(NotImplementedError, match="item 24"):
        olearner.online_update_contract   # noqa: B018


# ------------------------------------------------ the label feed
def test_label_feed_joins_bounds_and_replay(online_state):
    def drive(feed):
        feed.record_features(["r0", "r1"], [[1, 2, 3], [4, 5, 6]],
                             [[.1, .2, .3], [.4, .5, .6]])
        feed.record_features(["r2"], [[7, 8]], [[.7, .8]],
                             weights=[2.0])
        feed.on_join("r1", 1.0, 1.0)
        feed.on_join("r0", 0.0, 0.0)
        feed.on_join("r2", 1.0, 1.0)
        feed.on_join("ghost", 1.0, 1.0)     # features never staged
        return feed.take()

    a = drive(LabelFeed())
    b = drive(LabelFeed())
    idx, val, y, w = a
    assert idx.tolist() == [[4, 5, 6], [1, 2, 3], [7, 8, 0]]
    assert y.tolist() == [1.0, 0.0, 1.0] and w.tolist() == [1.0, 1.0, 2.0]
    for left, right in zip(a, b):
        assert np.array_equal(left, right)
    assert reliability_metrics.get(tnames.ONLINE_FEED_DROPPED) == 2
    assert reliability_metrics.get(tnames.ONLINE_FEED_PAIRS) == 6

    feed = LabelFeed(max_pairs=2)
    feed.record_features([f"p{i}" for i in range(3)],
                         np.arange(6).reshape(3, 2),
                         np.ones((3, 2), np.float32))
    for i in range(3):
        feed.on_join(f"p{i}", 1.0, 1.0)
    assert len(feed) == 2
    idx2, *_ = feed.take()
    assert idx2.tolist() == [[2, 3], [4, 5]]          # p0 evicted
    assert feed.take() is None
    assert feed.stats()["dropped_total"] == 1
    assert reliability_metrics.peek_gauge(tnames.ONLINE_BUFFER_PAIRS) == 0

    tight = LabelFeed(max_features=2)
    tight.record_features(["a", "b", "c"], np.zeros((3, 1), np.int32),
                          np.zeros((3, 1), np.float32))
    assert tight.stats()["pending_features"] == 2


def test_label_feed_subscribes_to_the_evaluator(online_state):
    ev = Q.StreamingEvaluator(kind="classification")
    feed = LabelFeed(evaluator=ev)
    feed.record_features(["a"], [[3, 4]], [[0.5, 1.0]])
    ev.record_prediction("a", 1.0)
    assert ev.record_label("a", 0.0) == "joined"
    idx, val, y, w = feed.take()
    assert idx.tolist() == [[3, 4]] and y.tolist() == [0.0]


# ------------------------------------------------ the learner
def test_online_learner_fixed_bucket_and_snapshot_exactness(online_state):
    idx, val, y, _ = _pairs(seed=3, n=300, k=8)
    lrn = OnlineLearner(VWParams(loss_function="logistic", num_bits=12,
                                 learning_rate=0.5), rows=64, device="cpu")
    first = lrn.partial_fit(idx[:128], val[:128], y[:128])
    assert first["updates"] == 2 and first["examples"] == 128
    assert lrn.k == 8
    snap = lrn.snapshot()
    for _ in range(4):
        out = lrn.partial_fit(idx, val, y)
    assert out["loss"] < first["loss"]
    assert lrn.updates == 2 + 4 * 5
    assert reliability_metrics.get(tnames.ONLINE_LEARNER_UPDATES) \
        == lrn.updates
    lrn.restore(snap)
    again = lrn.snapshot()
    for key in ("weights", "acc"):
        assert np.array_equal(again[key], snap[key])
    assert again["bias"] == snap["bias"] and lrn.updates == snap["updates"]
    # the same chunks after a restore reach the same bits
    a = lrn.partial_fit(idx, val, y)
    after_a = lrn.snapshot()
    lrn.restore(snap)
    b = lrn.partial_fit(idx, val, y)
    assert a == b
    assert np.array_equal(after_a["weights"], lrn.snapshot()["weights"])
    with pytest.raises(ValueError):
        lrn.partial_fit(np.zeros((4, 9), np.int32),
                        np.zeros((4, 9), np.float32), np.zeros(4))


def test_online_learner_warm_start_and_candidate_lineage(online_state,
                                                         tmp_path):
    ledger = tlineage.configure_run_ledger(str(tmp_path / "runs.jsonl"))
    model, idx, val, y, _ = _fit_vw(0)
    lrn = OnlineLearner(VWParams(loss_function="logistic",
                                 num_bits=model.num_bits),
                        warm_start=model, rows=64, device="cpu")
    assert np.array_equal(lrn.snapshot()["weights"],
                          np.asarray(model._weights))
    lrn.partial_fit(idx[:64], val[:64], y[:64])
    cand = lrn.make_model(reference_profile=None, reason="drift")
    assert cand.lineage["estimator"] == "OnlineLearner"
    assert cand.lineage["reason"] == "drift"
    ref = cand.transform(Table({"features_idx": idx[:32],
                                "features_val": val[:32]}))
    assert set(np.asarray(ref["prediction"]).tolist()) <= {0.0, 1.0}
    versions = [r for r in ledger.records() if "content_digest" in r]
    assert versions, "candidate ModelVersion not journaled"
    with pytest.raises(ValueError):
        OnlineLearner(VWParams(num_bits=10), warm_start=model, device="cpu")


# ------------------------------------------------ pure state machine
def test_machine_pure_transitions(online_state):
    sm = ContinuousLearnerMachine(OnlineConfig(min_pairs=8,
                                               cooldown_polls=2))
    assert sm.on_observation(OnlineObservation()) is None
    assert sm.on_observation(OnlineObservation(drift_tripped=True,
                                               pairs=3)) is None
    act = sm.on_observation(OnlineObservation(drift_tripped=True, pairs=9))
    assert act == OnlineAction("refit", reason="drift")
    assert sm.state == ol.REFITTING
    assert sm.on_observation(OnlineObservation(drift_tripped=True,
                                               pairs=99)) is None
    assert sm.on_refit_result(True) == OnlineAction("deploy")
    assert sm.state == ol.CANARYING
    sm.on_rollout_result(True)
    assert sm.state == ol.WATCHING and sm.last_outcome == "promoted"
    hot = OnlineObservation(floor_burning=True, pairs=99)
    assert sm.on_observation(hot) is None
    assert sm.on_observation(hot) is None
    assert sm.on_observation(hot) == OnlineAction("refit",
                                                  reason="floor-burn")
    assert sm.on_refit_result(False) is None
    assert sm.state == ol.WATCHING and sm.last_outcome == "refit-failed"
    assert sm.on_refit_result(True) is None
    sm.on_rollout_result(False)
    assert sm.last_outcome == "refit-failed"


def _trigger_once():
    fired = {"n": 0}

    def observe():
        fired["n"] += 1
        return OnlineObservation(drift_tripped=fired["n"] == 1, pairs=999)
    return observe


def _loaded_learner_and_feed(seed=0):
    model, idx, val, y, _ = _fit_vw(seed)
    lrn = OnlineLearner(VWParams(loss_function="logistic",
                                 num_bits=model.num_bits),
                        warm_start=model, rows=64, k=8, device="cpu")
    feed = LabelFeed()
    n = 128
    rids = [f"r{i}" for i in range(n)]
    feed.record_features(rids, idx[:n], val[:n])
    for i, rid in enumerate(rids):
        feed.on_join(rid, 1.0, float(y[i]))
    return model, lrn, feed


# ------------------------------------------------ chaos: online.refit
def test_refit_crash_chaos_rewinds_and_retry_converges(online_state,
                                                       tmp_path):
    ledger = tlineage.configure_run_ledger(str(tmp_path / "runs.jsonl"))
    _, clean_lrn, clean_feed = _loaded_learner_and_feed(0)
    clean = ContinuousLearner(clean_lrn, clean_feed,
                              deploy=lambda m: True,
                              observe=_trigger_once(),
                              config=OnlineConfig(min_pairs=8),
                              sleep=lambda s: None)
    assert clean.run_once()["outcome"] == "promoted"

    inj = FaultInjector(seed=5, rules=[
        {"site": "online.refit", "kind": "crash", "at": [0]}])
    _, lrn, feed = _loaded_learner_and_feed(0)
    cl = ContinuousLearner(lrn, feed, deploy=lambda m: True,
                           observe=_trigger_once(),
                           config=OnlineConfig(min_pairs=8),
                           ledger=ledger, faults=inj,
                           sleep=lambda s: None)
    status = cl.run_once()
    assert status["outcome"] == "promoted", status
    assert reliability_metrics.get(tnames.ONLINE_REFIT_RETRIES) == 1
    got, want = lrn.snapshot(), clean_lrn.snapshot()
    assert np.array_equal(got["weights"], want["weights"])
    assert np.array_equal(got["acc"], want["acc"])
    assert got["bias"] == want["bias"]
    events = [r["event"] for r in ledger.records() if "event" in r]
    order = [tnames.ONLINE_TRIP_EVENT, tnames.ONLINE_REFIT_EVENT,
             tnames.ONLINE_DEPLOY_EVENT, tnames.ONLINE_PROMOTE_EVENT]
    idx = [events.index(e) for e in order]
    assert idx == sorted(idx), events

    inj2 = FaultInjector(seed=5, rules=[
        {"site": "online.refit", "kind": "crash", "at": [0, 1, 2]}])
    _, lrn2, feed2 = _loaded_learner_and_feed(0)
    snap = lrn2.snapshot()
    deployed = []
    ledger2 = tlineage.configure_run_ledger(str(tmp_path / "r2.jsonl"))
    cl2 = ContinuousLearner(lrn2, feed2,
                            deploy=lambda m: deployed.append(m) or True,
                            observe=_trigger_once(),
                            config=OnlineConfig(min_pairs=8),
                            ledger=ledger2, faults=inj2,
                            sleep=lambda s: None)
    status2 = cl2.run_once()
    assert status2["outcome"] == "refit-failed", status2
    assert deployed == []
    after = lrn2.snapshot()
    assert np.array_equal(after["weights"], snap["weights"])
    assert after["acc"].sum() == snap["acc"].sum() == 0.0
    ev2 = [r["event"] for r in ledger2.records() if "event" in r]
    assert ev2 == [tnames.ONLINE_TRIP_EVENT]
    assert cl2.machine.state == ol.WATCHING


def test_poisoned_refit_burns_canary_and_rolls_back(online_state,
                                                    tmp_path):
    from mmlspark_tpu_torch.control import (Observation, RolloutConfig,
                                            RolloutDriver)
    from mmlspark_tpu_torch.control import rollout as ctl
    from mmlspark_tpu_torch.io.plan import compile_serving_transform
    ledger = tlineage.configure_run_ledger(str(tmp_path / "runs.jsonl"))
    inc, lrn, feed = _loaded_learner_and_feed(0)
    worker = compile_serving_transform(inc, ["features_idx",
                                             "features_val"])
    inc_version = worker.version
    snap = lrn.snapshot()

    def deploy(candidate):
        sched = iter([Observation(burning=True), Observation(),
                      Observation(), Observation()])
        drv = RolloutDriver(
            {"w0": worker}, inc, candidate,
            observe=lambda: next(sched), ledger=ledger,
            config=RolloutConfig(traffic_steps=(1.0,), step_polls=2,
                                 poll_interval_s=0.0, recover_polls=1),
            sleep=lambda s: None)
        return drv.run()["state"] == ctl.PROMOTED

    cl = ContinuousLearner(lrn, feed, deploy=deploy,
                           observe=_trigger_once(),
                           config=OnlineConfig(min_pairs=8),
                           ledger=ledger, sleep=lambda s: None)
    status = cl.run_once()
    assert status["outcome"] == "rolled-back", status
    assert worker.version == inc_version
    assert np.array_equal(lrn.snapshot()["weights"], snap["weights"])
    assert lrn.refits == snap["refits"]
    assert reliability_metrics.get(tnames.ONLINE_ROLLBACKS) == 1
    assert reliability_metrics.get(tnames.ONLINE_PROMOTIONS) == 0
    events = [r["event"] for r in ledger.records() if "event" in r]
    order = [tnames.ONLINE_TRIP_EVENT, tnames.ONLINE_REFIT_EVENT,
             tnames.ONLINE_DEPLOY_EVENT,
             tnames.CONTROL_ROLLOUT_ROLLBACK_EVENT,
             tnames.ONLINE_ROLLBACK_EVENT]
    idx = [events.index(e) for e in order]
    assert idx == sorted(idx), events
    assert tnames.ONLINE_PROMOTE_EVENT not in events


# ------------------------------------------------ the acceptance (e2e)
def test_self_healing_shift_refit_promote_zero_drops(online_state,
                                                     tmp_path):
    from mmlspark_tpu_torch.control import (Observation, RolloutConfig,
                                            RolloutDriver)
    from mmlspark_tpu_torch.control import rollout as ctl
    from mmlspark_tpu_torch.io.serving import serve_pipeline

    ledger = tlineage.configure_run_ledger(str(tmp_path / "runs.jsonl"))
    inc, idx, val, y, beta = _fit_vw(0)
    k = idx.shape[1]
    shift = (5.0 * beta / np.linalg.norm(beta)).astype(np.float32)

    server, q = serve_pipeline(inc, input_cols=["features_idx",
                                                "features_val"],
                               mode="continuous")
    statuses = []
    try:
        mon = Q.get_monitor()
        assert mon.active, "VW fit did not stamp a quality profile"
        mon.configure(sample=1.0, min_live=24)
        feed = LabelFeed(evaluator=mon.evaluator)
        lrn = OnlineLearner(VWParams(loss_function="logistic",
                                     num_bits=inc.num_bits),
                            warm_start=inc, rows=64, k=k, device="cpu")

        def post(row_idx, row_val, label):
            body = json.dumps({"features_idx": row_idx.tolist(),
                               "features_val": row_val.tolist()}).encode()
            req = urllib.request.Request(
                server.address, data=body,
                headers={"Content-Type": "application/json"})
            resp = urllib.request.urlopen(req, timeout=15)
            resp.read()
            statuses.append(resp.status)
            rid = resp.headers["X-Request-Id"]
            feed.record_features([rid], row_idx[None, :], row_val[None, :])
            Q.record_label(rid, float(label))

        for i in range(8):
            post(idx[i], val[i], y[i])
        recompiles_before = reliability_metrics.get(
            tnames.PLAN_RECOMPILES)

        def deploy(candidate):
            sched = iter([Observation()] * 10)
            drv = RolloutDriver(
                {"w0": q.transform_fn}, inc, lambda: candidate,
                observe=lambda: next(sched), ledger=ledger,
                config=RolloutConfig(traffic_steps=(1.0,), step_polls=1,
                                     soak_polls=1, poll_interval_s=0.0),
                sleep=lambda s: None)
            return drv.run()["state"] == ctl.PROMOTED

        cl = ContinuousLearner(
            lrn, feed, deploy=deploy,
            config=OnlineConfig(min_pairs=32, max_drift=0.5,
                                poll_interval_s=0.0),
            ledger=ledger, sleep=lambda s: None)
        assert cl.run_once()["action"] is None

        shifted = val + shift
        y_shift = (shifted @ beta > 0).astype(np.float32)
        for i in range(72):
            post(idx[i], shifted[i], y_shift[i])
        assert all(s == 200 for s in statuses)

        status = cl.run_once()
        assert status.get("outcome") == "promoted", status
        assert q.transform_fn.version != tlineage.model_version(
            inc).version
        assert reliability_metrics.get(tnames.ONLINE_TRIPS) == 1
        assert reliability_metrics.get(tnames.ONLINE_PROMOTIONS) == 1

        for i in range(8):
            post(idx[i], shifted[i], y_shift[i])
        assert all(s == 200 for s in statuses)
        assert len(statuses) == 88
        assert reliability_metrics.get(tnames.PLAN_RECOMPILES) \
            == recompiles_before == 0

        obs = cl._default_observe()
        assert not obs.drift_tripped, obs

        events = [r["event"] for r in ledger.records() if "event" in r]
        order = [tnames.ONLINE_TRIP_EVENT, tnames.ONLINE_REFIT_EVENT,
                 tnames.ONLINE_DEPLOY_EVENT,
                 tnames.CONTROL_ROLLOUT_PROMOTE_EVENT,
                 tnames.ONLINE_PROMOTE_EVENT]
        order_idx = [events.index(e) for e in order]
        assert order_idx == sorted(order_idx), events
        trip = next(r for r in ledger.records()
                    if r.get("event") == tnames.ONLINE_TRIP_EVENT)
        assert trip["reason"] == "drift" and trip["pairs"] >= 32
    finally:
        q.stop()
        server.stop()


def test_default_observe_floor_burn_from_slo_window():
    from mmlspark_tpu_torch.telemetry import slo as tslo
    metric = "quality.eval.accuracy"
    cl = ContinuousLearner(None, [], deploy=lambda m: True,
                           sleep=lambda s: None)
    reliability_metrics.reset("quality.")
    tslo.configure(tslo.quality_objectives(metric_floor=0.8))
    try:
        assert not cl._default_observe().floor_burning
        reliability_metrics.set_gauge(metric, 0.92)
        assert not cl._default_observe().floor_burning
        reliability_metrics.set_gauge(metric, 0.41)
        obs = cl._default_observe()
        assert obs.floor_burning and obs.triggered
        assert obs.detail == {"slo": ["quality.metric.floor"]}
        reliability_metrics.set_gauge(metric, 0.95)
        assert not cl._default_observe().floor_burning
    finally:
        tslo.configure()
        reliability_metrics.reset("quality.")
