"""Port parity: the control plane (`control/`: rollout, actuators) and
the telemetry it reads (`telemetry/slo.py`, `telemetry/watch.py`).

Against the reference on the same inputs, exactly (these are host
Python; the same observations must give the same answers):
- the SLO engine's verdicts over equal registries, and `merge_verdicts`
  of equal per-worker verdicts;
- `evaluate_rule` over a table of series and rules;
- the rollout state machine's actions and states over seeded schedules;
- the canary and quality watch rules.
Then the port on its own, as the reference's `tests/test_control.py`:
the driver's promote and rollback over port `ServingTransform`s (a
seeded `serving.swap` fault mid-rollback retried, `if_changed=True`
idempotent), the poll chaos site, a live two-worker fleet that promotes a
healthy candidate and rolls a poisoned one back with zero dropped
requests and its `/slo` verdict recovered, the weighted router, burn-
aware admission shedding with `Retry-After`, and the fleet scaler.
"""
import ast
import collections
import functools
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu.control import rollout as ref_ctl
from mmlspark_tpu.reliability.metrics import MetricsRegistry as RefRegistry
from mmlspark_tpu.telemetry import lineage as ref_lineage
from mmlspark_tpu.telemetry import quality as ref_quality
from mmlspark_tpu.telemetry import slo as ref_slo
from mmlspark_tpu.telemetry import watch as ref_watch
from mmlspark_tpu_torch.control import (Action, BurnAwareAdmission,
                                        FleetScaler, Observation,
                                        RolloutConfig, RolloutDriver,
                                        RolloutStateMachine, WeightedRouter)
from mmlspark_tpu_torch.control import rollout as ctl
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.reliability.faults import FaultInjector
from mmlspark_tpu_torch.reliability.metrics import (MetricsRegistry,
                                                    reliability_metrics)
from mmlspark_tpu_torch.telemetry import exposition
from mmlspark_tpu_torch.telemetry import lineage as tlineage
from mmlspark_tpu_torch.telemetry import names as tnames
from mmlspark_tpu_torch.telemetry import quality as tquality
from mmlspark_tpu_torch.telemetry import slo as tslo
from mmlspark_tpu_torch.telemetry import watch as twatch

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def control_state():
    from mmlspark_tpu_torch.telemetry import perf
    reliability_metrics.reset()
    tlineage.reset_version_registry()
    tlineage.configure_run_ledger(None)
    tslo.configure()
    perf.get_compile_log().clear()
    yield
    perf.get_compile_log().clear()
    tslo.configure()
    tlineage.configure_run_ledger(None)
    tlineage.reset_version_registry()
    reliability_metrics.reset()


@functools.lru_cache(maxsize=None)
def _fit(seed=0, n=300, f=5):
    """A fitted VW classifier on dense features (different seeds ->
    distinct content digests); cached, read-only in every test."""
    from mmlspark_tpu_torch.models.vw import VowpalWabbitClassifier
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
    return VowpalWabbitClassifier(num_bits=12, num_tasks=1,
                                  device="cpu").fit(
        Table({"features": x, "label": y}))


class _PoisonModel:
    """A candidate whose artifact cannot score: versions fine, installs
    fine, and raises server-side (-> 502s) on every batch."""

    def transform(self, table):
        raise RuntimeError("bad candidate: artifact cannot score")

    def _get_state(self):
        return {"poison": np.asarray([1.0], np.float32)}


# ------------------------------------------------ SLO engine parity
def _observe_both(seed):
    """The same seeded serving traffic into a port and a reference
    registry."""
    rng = np.random.default_rng(seed)
    regs = (MetricsRegistry(), RefRegistry())
    lat = rng.lognormal(3.0, 1.2, size=400)
    errors = int(rng.integers(0, 20))
    gauges = {tnames.TRAIN_GOODPUT: float(rng.uniform(0.5, 1.0)),
              tnames.QUALITY_DRIFT_MAX: float(rng.uniform(0, 0.5)),
              "quality.eval.accuracy": float(rng.uniform(0.6, 1))}
    for reg in regs:
        for ms in lat:
            reg.observe_ms(tnames.SERVING_REQUEST_E2E, float(ms))
        reg.inc(tnames.SERVING_REQUEST_TOTAL, 400)
        if errors:
            reg.inc(tnames.SERVING_REQUEST_ERRORS, errors)
        for name, value in gauges.items():
            reg.set_gauge(name, value)
    return regs


def _objective_sets(mod):
    return [mod.default_objectives(),
            mod.default_objectives() + mod.trainer_objectives(0.8),
            mod.quality_objectives(metric_floor=0.85)
            + mod.canary_objectives(),
            [mod.Objective(name="tight", kind=mod.LATENCY,
                           metric=tnames.SERVING_REQUEST_E2E,
                           threshold_ms=20.0, quantile=90.0, window_s=5.0)]]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("which", range(4))
def test_slo_verdicts_equal_reference(seed, which):
    port_reg, ref_reg = _observe_both(seed)
    got = tslo.SLOEngine(_objective_sets(tslo)[which], registry=port_reg,
                         long_factor=3.0).verdict()
    want = ref_slo.SLOEngine(_objective_sets(ref_slo)[which],
                             registry=ref_reg,
                             long_factor=3.0).verdict(notify=False)
    assert got == want


def test_merge_verdicts_equal_reference():
    verdicts = []
    for seed in range(3):
        port_reg, _ = _observe_both(seed)
        verdicts.append(tslo.SLOEngine(
            _objective_sets(tslo)[1] + _objective_sets(tslo)[2],
            registry=port_reg).verdict())
    assert tslo.merge_verdicts(verdicts) == ref_slo.merge_verdicts(verdicts)
    assert tslo.merge_verdicts([]) is None
    for v in (None, {}, {"burning": True}, {"burning": False}):
        assert tslo.verdict_burning(v) == ref_slo.verdict_burning(v)


def test_engine_configure_and_no_data():
    eng = tslo.configure(tslo.quality_objectives(), long_factor=2.0)
    assert tslo.get_engine() is eng and eng.long_factor == 2.0
    v = tslo.SLOEngine(tslo.quality_objectives(),
                       registry=MetricsRegistry()).verdict()
    assert v["ok"] and not v["burning"]   # absence of evidence
    assert tslo.configure().objectives == tslo.default_objectives()


# ------------------------------------------------ watcher parity
_SERIES = [[(i, v) for i, v in enumerate(vals)] for vals in (
    [1.0] * 20, [1.0] * 8 + [3.0] * 8, [5.0] * 8 + [1.0] * 8,
    [0.0] * 16, [1.0, 2.0, 3.0], [0.0] * 8 + [1.0] * 8,
    list(np.linspace(1, 10, 30)))]
_RULES = [dict(key="k", max_value=2.5), dict(key="k", min_value=0.5),
          dict(key="k", shift=2.0), dict(key="k", shift=2.0,
                                         direction="up"),
          dict(key="k", shift=2.0, direction="down", window=4),
          dict(key="k", max_value=100.0, shift=1.5, min_samples=2)]


@pytest.mark.parametrize("rule", _RULES)
def test_evaluate_rule_equals_reference(rule):
    for series in _SERIES:
        assert twatch.evaluate_rule(twatch.WatchRule(**rule), series) == \
            ref_watch.evaluate_rule(ref_watch.WatchRule(**rule), series)


def test_watcher_transitions_and_rules(control_state):
    class _Recorder:
        def __init__(self):
            self.calls = []

        def on_verdict(self, verdict, reason=None, source=None):
            self.calls.append((verdict["burning"], source))

    rec = _Recorder()
    w = twatch.TelemetryWatcher(rules=[dict(key="p99", max_value=10.0,
                                            min_samples=1)],
                                recorder=rec)
    assert w.check({"p99": [(0, 5.0)]}) == []
    trips = w.check({"p99": [(0, 5.0), (1, 50.0)]})
    assert [t["key"] for t in trips] == ["p99"]
    assert w.check({"p99": [(2, 60.0)]}) == []        # still tripped
    assert w.tripped() == {"p99": {"key": "p99", "kind": "threshold",
                                   "value": 60.0, "bound": 10.0,
                                   "direction": "up"}}
    w.check({"p99": [(3, 1.0)]})                      # recovered
    assert rec.calls == [(True, "watch:p99"), (False, "watch:p99")]
    assert reliability_metrics.get(tnames.TELEMETRY_WATCH_TRIPS) == 1
    assert reliability_metrics.peek_gauge(tnames.TELEMETRY_WATCH_TRIPPED) \
        == 0
    with pytest.raises(ValueError):
        twatch.TelemetryWatcher(rules=[dict(key="x")])
    assert tlineage.canary_watch_rules(3.0) == [
        twatch.WatchRule(**r._asdict())
        for r in ref_lineage.canary_watch_rules(3.0)]
    assert tquality.quality_watch_rules(0.2, min_metric=0.7) == [
        twatch.WatchRule(**r._asdict())
        for r in ref_quality.quality_watch_rules(0.2, min_metric=0.7)]


# ------------------------------------------------ state machine parity
def _schedule(seed, n=12):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.random()
        out.append(dict(burning=bool(r < 0.08),
                        tripped=bool(0.08 <= r < 0.12)))
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("steps, step_polls, soak_polls", [
    ((0.25, 0.5, 1.0), 2, 3), ((1.0,), 1, 1), ((0.5, 1.0), 3, 0)])
def test_state_machine_equals_reference(seed, steps, step_polls,
                                        soak_polls):
    cfg = dict(traffic_steps=steps, step_polls=step_polls,
               soak_polls=soak_polls)
    got_m = RolloutStateMachine(RolloutConfig(**cfg))
    want_m = ref_ctl.RolloutStateMachine(ref_ctl.RolloutConfig(**cfg))
    trace = [(tuple(got_m.start()), tuple(want_m.start()))]
    for obs in _schedule(seed):
        a = got_m.on_observation(Observation(**obs))
        b = want_m.on_observation(ref_ctl.Observation(**obs))
        trace.append((a and tuple(a), b and tuple(b)))
        assert (got_m.state, got_m.step, got_m.fraction) == \
            (want_m.state, want_m.step, want_m.fraction)
        if got_m.state == ctl.ROLLING_BACK:
            ok = bool(seed % 2)
            got_m.on_rollback_result(ok)
            want_m.on_rollback_result(ok)
    for a, b in trace:
        assert a == b


def test_state_machine_config_validation():
    for bad in (dict(traffic_steps=(0.25, 0.5)),
                dict(traffic_steps=(0.5, 0.25, 1.0)),
                dict(traffic_steps=(0.0, 1.0)), dict(step_polls=0)):
        with pytest.raises(ValueError):
            RolloutStateMachine(RolloutConfig(**bad))
    sm = RolloutStateMachine()
    assert sm.start() == Action("install", fraction=0.25)
    with pytest.raises(RuntimeError):
        sm.start()


# ------------------------------------------------ driver
class _FakeTransform:
    def __init__(self, model):
        self.installs = []
        self.fail_installs = 0
        self.version = tlineage.model_version(model).version

    def install_model(self, model, if_changed=False):
        mv = tlineage.model_version(model)
        if if_changed and mv.version == self.version:
            return {"old": self.version, "new": self.version,
                    "unchanged": True}
        if self.fail_installs > 0:
            self.fail_installs -= 1
            raise RuntimeError("swap failed")
        self.installs.append(mv.version)
        old, self.version = self.version, mv.version
        return {"old": old, "new": mv.version}


def _driver(workers, incumbent, candidate, schedule, tmp_path=None,
            **cfg_kw):
    sched = iter(schedule)
    ledger = (tlineage.configure_run_ledger(str(tmp_path / "runs.jsonl"))
              if tmp_path is not None else None)
    cfg = RolloutConfig(**{"poll_interval_s": 0.0, "recover_polls": 2,
                           **cfg_kw})
    return RolloutDriver(workers, incumbent, candidate,
                         observe=lambda: next(sched), config=cfg,
                         ledger=ledger, sleep=lambda s: None)


def test_driver_promotes_staged_and_rolls_back_idempotently(
        control_state, tmp_path):
    inc, cand = _fit(0), _fit(1)
    workers = {f"w{i}": _FakeTransform(inc) for i in range(4)}
    drv = _driver(workers, inc, cand, schedule=[Observation()] * 30,
                  tmp_path=tmp_path, traffic_steps=(0.25, 0.5, 1.0),
                  step_polls=1, soak_polls=1)
    status = drv.run()
    assert status["state"] == ctl.PROMOTED
    assert status["candidate_on"] == ["w0", "w1", "w2", "w3"]
    assert reliability_metrics.get(tnames.CONTROL_ROLLOUT_PROMOTIONS) == 1

    workers = {"w0": _FakeTransform(inc), "w1": _FakeTransform(inc)}
    drv = _driver(workers, inc, cand,
                  schedule=[Observation(), Observation(burning=True),
                            Observation(), Observation()],
                  tmp_path=tmp_path, traffic_steps=(0.5, 1.0),
                  step_polls=2)
    status = drv.run()
    assert status["state"] == ctl.ROLLED_BACK
    assert workers["w0"].version == drv.incumbent_version
    before = workers["w0"].installs[:]
    assert drv.rollback() is True
    assert workers["w0"].installs == before
    assert reliability_metrics.get(tnames.CONTROL_ROLLOUT_ROLLBACKS) == 1
    events = [r["event"] for r in drv._ledger.records() if "event" in r]
    order = [tnames.CONTROL_ROLLOUT_DEPLOY_EVENT,
             tnames.CONTROL_ROLLOUT_BURN_EVENT,
             tnames.CONTROL_ROLLOUT_ROLLBACK_EVENT,
             tnames.CONTROL_ROLLOUT_RECOVERED_EVENT]
    tail = events[events.index(tnames.CONTROL_ROLLOUT_PROMOTE_EVENT) + 1:]
    idx = [tail.index(e) for e in order]
    assert idx == sorted(idx), events
    with pytest.raises(ValueError):
        RolloutDriver({"w0": _FakeTransform(inc)}, inc, inc,
                      observe=lambda: Observation())


def test_driver_rollback_retry_after_serving_swap_fault(control_state):
    """Over the port's ServingTransform: the candidate installs, a seeded
    `serving.swap` fault fails the rollback's re-install once, the retry
    lands, and `install_model(if_changed=True)` is a version no-op."""
    from mmlspark_tpu_torch.io.plan import compile_serving_transform
    inc, cand = _fit(0), _fit(1)
    inj = FaultInjector(seed=7, rules=[
        {"site": "serving.swap", "kind": "error", "at": [1]}])
    transform = compile_serving_transform(inc, ["features"], faults=inj)
    drv = _driver({"w0": transform}, inc, cand,
                  schedule=[Observation(burning=True), Observation()],
                  traffic_steps=(1.0,), step_polls=1)
    status = drv.run()
    assert status["state"] == ctl.ROLLED_BACK
    assert transform.version == drv.incumbent_version
    assert reliability_metrics.get(
        tnames.CONTROL_ROLLOUT_ROLLBACK_RETRIES) >= 1
    assert reliability_metrics.get(tnames.SERVING_MODEL_SWAP_ERRORS) == 1
    swaps = reliability_metrics.get(tnames.SERVING_MODEL_SWAPS)
    assert drv.rollback() is True
    assert transform.install_model(inc, if_changed=True)["unchanged"]
    assert reliability_metrics.get(tnames.SERVING_MODEL_SWAPS) == swaps


def test_driver_deploy_failure_rolls_back(control_state, tmp_path):
    inc, cand = _fit(0), _fit(1)
    w = _FakeTransform(inc)
    w.fail_installs = 10
    drv = _driver({"w0": w}, inc, cand, schedule=[Observation()] * 4,
                  tmp_path=tmp_path, traffic_steps=(1.0,), step_polls=1)
    assert drv.run()["state"] == ctl.ROLLED_BACK
    assert w.version == drv.incumbent_version


# ------------------------------------------------ live fleet
def _start_fleet(model, n_workers, registry_ttl=60.0):
    from mmlspark_tpu_torch.io.registry import (ServiceRegistry,
                                                report_server_to_registry)
    from mmlspark_tpu_torch.io.serving import serve_pipeline
    registry = ServiceRegistry(ttl_s=registry_ttl).start()
    fleet = []
    for i in range(n_workers):
        server, q = serve_pipeline(model, input_cols=["features"],
                                   mode="microbatch", max_batch=64)
        host, port = server._httpd.server_address[:2]
        report_server_to_registry(registry.address, "serving", host, port,
                                  process_id=i,
                                  version=q.transform_fn.version)
        fleet.append((server, q))
    return registry, fleet


def _stop_fleet(registry, fleet):
    for server, q in fleet:
        q.stop()
        server.stop()
    registry.stop()


def test_poll_fault_skips_round_and_slo_scrapes(control_state):
    inj = FaultInjector(seed=3, rules=[
        {"site": "control.rollout.poll", "kind": "error", "at": [0]}])
    inc, cand = _fit(0), _fit(1)
    registry, fleet = _start_fleet(inc, 1)
    try:
        drv = RolloutDriver({"w0": fleet[0][1].transform_fn}, inc, cand,
                            registry_address=registry.address,
                            faults=inj, sleep=lambda s: None)
        assert drv._observe() is None
        assert reliability_metrics.get(
            tnames.CONTROL_ROLLOUT_POLL_ERRORS) == 1
        obs = drv._observe()
        assert obs is not None and obs.healthy
        snap = exposition.scrape_cluster(registry.address, slo=True,
                                         versions=True)
        assert snap.slo["workers"] == 1 and snap.slo["ok"]
        assert list(snap.versions["slo_by_version"]) == \
            [fleet[0][1].transform_fn.version]
        with urllib.request.urlopen(fleet[0][0].address + "/slo",
                                    timeout=10) as resp:
            verdict = json.loads(resp.read())
        assert [o["objective"]["name"] for o in verdict["objectives"]] \
            == ["serving.e2e.p99", "serving.error_rate"]
    finally:
        _stop_fleet(registry, fleet)


def test_fleet_healthy_candidate_auto_promotes(control_state, tmp_path):
    ledger = tlineage.configure_run_ledger(str(tmp_path / "runs.jsonl"))
    inc, cand = _fit(0), _fit(1)
    registry, fleet = _start_fleet(inc, 2)
    try:
        driver = RolloutDriver(
            workers={f"w{i}": q.transform_fn
                     for i, (_, q) in enumerate(fleet)},
            incumbent=inc, candidate=cand,
            registry_address=registry.address, ledger=ledger,
            config=RolloutConfig(traffic_steps=(0.5, 1.0), step_polls=1,
                                 soak_polls=1, poll_interval_s=0.1))
        status = driver.run()
        assert status["state"] == ctl.PROMOTED, status
        for _, q in fleet:
            assert q.transform_fn.version == driver.candidate_version
        events = [r["event"] for r in ledger.records() if "event" in r]
        assert tnames.CONTROL_ROLLOUT_ROLLBACK_EVENT not in events
    finally:
        _stop_fleet(registry, fleet)


def test_fleet_poison_candidate_rolls_back_zero_dropped(control_state,
                                                        tmp_path):
    from mmlspark_tpu_torch.io.loadgen import run_load
    tslo.configure(objectives=[tslo.Objective(
        name="serving.error_rate", kind=tslo.ERROR_RATE,
        metric=tnames.SERVING_REQUEST_ERRORS,
        total_metric=tnames.SERVING_REQUEST_TOTAL,
        budget=0.05, window_s=1.0)], long_factor=2.0)
    ledger = tlineage.configure_run_ledger(str(tmp_path / "runs.jsonl"))
    inc = _fit(0)
    body = json.dumps({"features": [0.1] * 5})
    registry, fleet = _start_fleet(inc, 2)
    try:
        router = WeightedRouter(registry.address, "serving")
        driver = RolloutDriver(
            workers={f"w{i}": q.transform_fn
                     for i, (_, q) in enumerate(fleet)},
            incumbent=inc, candidate=_PoisonModel(),
            registry_address=registry.address, ledger=ledger,
            config=RolloutConfig(traffic_steps=(0.5, 1.0), step_polls=3,
                                 poll_interval_s=0.15,
                                 scrape_window_s=10.0, recover_polls=80))
        chunks = []
        stop = threading.Event()

        def pump():
            while not stop.is_set():
                chunks.append(run_load(
                    "", 0, body, n_clients=3, per_client=40,
                    check=lambda s, p: None,
                    post=lambda b: router.post(b.encode())))

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        try:
            status = driver.run()
        finally:
            stop.set()
            t.join(timeout=60)
        assert status["state"] == ctl.ROLLED_BACK, status
        for _, q in fleet:
            assert q.transform_fn.version == driver.incumbent_version
        n_sent = sum(c.n_sent for c in chunks)
        n_dropped = sum(c.n_dropped for c in chunks)
        by_status = collections.Counter()
        for c in chunks:
            by_status.update(c.n_by_status or {})
        assert n_sent > 0 and n_dropped == 0, (n_sent, n_dropped)
        assert by_status.get(502, 0) > 0, by_status
        assert by_status.get(200, 0) > 0, by_status
        snap = exposition.scrape_cluster(registry.address, slo=True)
        assert snap.slo["ok"] and not snap.slo["burning"]
        events = [r["event"] for r in ledger.records() if "event" in r]
        order = [tnames.CONTROL_ROLLOUT_DEPLOY_EVENT,
                 tnames.CONTROL_ROLLOUT_BURN_EVENT,
                 tnames.CONTROL_ROLLOUT_ROLLBACK_EVENT,
                 tnames.CONTROL_ROLLOUT_RECOVERED_EVENT]
        idx = [events.index(e) for e in order]
        assert idx == sorted(idx), events
    finally:
        _stop_fleet(registry, fleet)


# ------------------------------------------------ actuators
def _registered_registry(n=2):
    from mmlspark_tpu_torch.io.registry import ServiceInfo, ServiceRegistry
    reg = ServiceRegistry().start()
    infos = []
    for i in range(n):
        info = ServiceInfo(name="serving", host="127.0.0.1",
                           port=9000 + i, process_id=i, num_partitions=1)
        reg._put(info)
        infos.append(info)
    return reg, infos


def test_weighted_router_swrr_and_scrape_costs(control_state):
    reg, infos = _registered_registry(2)
    try:
        router = WeightedRouter(reg.address, "serving")
        a, b = (f"{i.host}:{i.port}" for i in infos)
        assert sorted(collections.Counter(
            router._next_target().port for _ in range(6)).values()) \
            == [3, 3]
        router.set_weights({a: 300, b: 100})
        seq = [f"{t.host}:{t.port}" for t in
               (router._next_target() for _ in range(8))]
        assert seq.count(a) == 6 and seq.count(b) == 2
        assert b in seq[:4] and b in seq[4:]
        assert reliability_metrics.peek_gauge(
            tnames.control_router_weight(a)) == 300.0
        snap = exposition.ClusterSnapshot(
            merged={},
            workers=[(infos[0], {"gauges": {"serving.queue_depth": 0}}),
                     (infos[1], {"gauges": {"serving.queue_depth": 9}})])
        assert router.update_from_scrape(snap) == {a: 100, b: 10}
    finally:
        reg.stop()


def test_burn_aware_admission_sheds_before_queue(control_state):
    from mmlspark_tpu_torch.io.loadgen import run_load
    from mmlspark_tpu_torch.io.serving import ServingQuery, ServingServer

    burning = [False]
    adm = BurnAwareAdmission(verdict_fn=lambda: {"burning": burning[0]},
                             refresh_s=0.0, retry_after_s=2.5,
                             queue_allowance=1)
    server = ServingServer(port=0, num_partitions=1,
                           admission=adm).start()

    def slow_transform(bodies):
        time.sleep(0.01)
        return [{"y": 1.0} for _ in bodies]

    q = ServingQuery(server, slow_transform, mode="microbatch",
                     max_batch=4).start()
    try:
        host, port = server._httpd.server_address[:2]
        body = json.dumps({"x": 1.0})
        res = run_load(host, port, body, n_clients=6, per_client=20)
        assert not res.errors
        assert reliability_metrics.get(tnames.CONTROL_ADMISSION_SHED) == 0
        burning[0] = True
        res = run_load(host, port, body, n_clients=6, per_client=20,
                       check=lambda s, p: None)
        shed = reliability_metrics.get(tnames.CONTROL_ADMISSION_SHED)
        assert shed > 0
        assert res.n_by_status.get(503, 0) == shed
        assert res.n_by_status.get(200, 0) > 0
        assert res.n_dropped == 0
        depth = reliability_metrics.peek_gauge(tnames.SERVING_QUEUE_DEPTH)
        assert depth is not None and depth <= adm.queue_allowance + 1
        adm.queue_allowance = -1
        for transport_address in (f"http://{host}:{port}/",):
            req = urllib.request.Request(
                transport_address, data=body.encode(),
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=10).read()
            assert ei.value.code == 503
            assert ei.value.headers.get("Retry-After") == "2"
        adm.queue_allowance = 1
        burning[0] = False
        res = run_load(host, port, body, n_clients=4, per_client=10)
        assert not res.errors
    finally:
        q.stop()
        server.stop()


def test_admission_on_the_threading_transport(control_state):
    from mmlspark_tpu_torch.io.serving import serve_pipeline
    adm = BurnAwareAdmission(verdict_fn=lambda: {"burning": True},
                             refresh_s=0.0, retry_after_s=7.0,
                             queue_allowance=-1)
    server, q = serve_pipeline(_fit(0), ["features"], admission=adm)
    try:
        assert server.admission is adm
        req = urllib.request.Request(
            server.address, data=json.dumps({"features": [0.1] * 5})
            .encode(), headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10).read()
        assert ei.value.code == 503
        assert ei.value.headers.get("Retry-After") == "7"
    finally:
        q.stop()
        server.stop()


def test_burn_aware_admission_caches_and_fails_open(control_state):
    calls = [0]

    def verdict():
        calls[0] += 1
        return {"burning": True}

    now = [0.0]
    adm = BurnAwareAdmission(verdict_fn=verdict, refresh_s=10.0,
                             clock=lambda: now[0])
    assert adm.should_shed(5) is True
    assert adm.should_shed(5) is True
    assert calls[0] == 1
    now[0] = 11.0
    assert adm.should_shed(5) is True
    assert calls[0] == 2
    assert adm.should_shed(0) is False

    def broken():
        raise RuntimeError("slo engine down")
    assert BurnAwareAdmission(verdict_fn=broken,
                              refresh_s=0.0).should_shed(100) is False
    # the default reads the process engine: idle, nothing burns
    assert BurnAwareAdmission(refresh_s=0.0).should_shed(100) is False


def test_fleet_scaler_policy_and_debounce(control_state):
    sc = FleetScaler(high=0.75, low=0.15, window=3, min_workers=1,
                     max_workers=4)
    assert sc.decide([0.8, 0.9, 0.8], 2) == "spawn"
    assert sc.decide([0.8, 0.9, 0.8], 4) is None
    assert sc.decide([0.1, 0.0, 0.1], 2) == "drain"
    assert sc.decide([0.1, 0.0, 0.1], 1) is None
    assert sc.decide([0.8, 0.5, 0.8], 2) is None
    assert sc.decide([0.9, 0.9], 2) is None
    fired = []
    sc = FleetScaler(spawn=lambda: fired.append("spawn"),
                     drain=lambda: fired.append("drain"),
                     high=0.75, low=0.15, window=2, cooldown=2,
                     min_workers=1, max_workers=4)
    assert sc.observe(0.9, 2) is None
    assert sc.observe(0.9, 2) == "spawn"
    assert sc.observe(0.9, 3) is None
    assert sc.observe(0.9, 3) is None
    assert sc.observe(0.9, 3) == "spawn"
    assert fired == ["spawn", "spawn"]
    assert reliability_metrics.get(tnames.CONTROL_SCALER_SPAWNS) == 2
    with pytest.raises(ValueError):
        FleetScaler(high=0.1, low=0.5)


def test_control_modules_import_no_torch():
    """The control plane is host Python: no module of the package imports
    torch (or anything outside the standard library and the port)."""
    pkg = os.path.join(_REPO, "mmlspark_tpu_torch", "control")
    for fname in sorted(os.listdir(pkg)):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(pkg, fname)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in ("math", "time", "threading",
                                           "collections", "typing",
                                           "__future__"), (fname, m)
