"""Port parity: the serving half of telemetry (`mmlspark_tpu_torch.telemetry`,
`reliability.metrics`, `train.metrics`, `utils.tracing`).

The same observations go into both packages, JAX on the CPU and the port
with `device="cpu"`, and come out equal:
- `render_prometheus` gives identical text, `merge_states` /
  `state_snapshot` identical dicts, windowed states and exemplars the
  same buckets;
- `QualityMonitor`: equal drift, `export_quality` and evaluator state for
  the same features, predictions and labels; the label join's anomaly
  verdicts and counters equal;
- `VersionRegistry` exports equal up to the version ids (the port's
  fingerprint hashes its own module names, so the ids differ by design);
- `train.metrics` states and metrics equal;
- the metric names are the reference's strings.

The rest pins the port's deployment contracts, named after the reference
tests they mirror (`tests/test_deployment_observability.py`): the
two-digest version identity, the run ledger, a hot-swap under load that
drops no request with every reply stamped `X-Model-Version`, a failed
swap rolling back, and the exposition GETs: `/metrics`,
`/metrics.json?window=`, `/quality` and `/versions` answer, `/slo`,
`/debug/bundle` and `/debug/profile` answer 501 naming their ROADMAP
items. No rate or latency floor is asserted.
"""
import copy
import glob
import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu import telemetry as ref_telemetry
from mmlspark_tpu.reliability import metrics as ref_metrics
from mmlspark_tpu.telemetry import exposition as ref_expo
from mmlspark_tpu.telemetry import lineage as ref_lineage
from mmlspark_tpu.telemetry import names as ref_names
from mmlspark_tpu.telemetry import quality as ref_quality
from mmlspark_tpu.telemetry import spans as ref_spans
from mmlspark_tpu.telemetry import window as ref_window
from mmlspark_tpu.train import metrics as ref_train_metrics
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.io import plan, serving
from mmlspark_tpu_torch.io.loadgen import run_load
from mmlspark_tpu_torch.models.gbdt.estimators import GBDTClassifier
from mmlspark_tpu_torch.reliability import metrics as port_metrics
from mmlspark_tpu_torch.reliability.faults import (FaultInjector,
                                                   InjectedFault)
from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
from mmlspark_tpu_torch.telemetry import exposition, lineage, names, perf
from mmlspark_tpu_torch.telemetry import quality, spans, window
from mmlspark_tpu_torch.train import metrics as train_metrics
from mmlspark_tpu_torch.utils import tracing

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

TRANSPORTS = ("selector", "threading")


@pytest.fixture(autouse=True)
def deploy_state():
    """Fresh metrics, quality monitor, version registry, run ledger and
    tracer sampling in both packages; restored after."""
    for reg, qual, lin in ((reliability_metrics, quality, lineage),
                           (ref_metrics.reliability_metrics, ref_quality,
                            ref_lineage)):
        reg.reset()
        qual.reset_monitor()
        lin.reset_version_registry()
        lin.configure_run_ledger(None)
    yield
    spans.configure(sample=0.0, tail_latency_ms=None)
    for reg, qual, lin in ((reliability_metrics, quality, lineage),
                           (ref_metrics.reliability_metrics, ref_quality,
                            ref_lineage)):
        lin.configure_run_ledger(None)
        lin.reset_version_registry()
        qual.reset_monitor()
        reg.reset()


def _fit(seed=0, n=400, f=5, iters=4, **kw):
    """One port model; different seeds give different fitted arrays (and
    content digests) of the same architecture."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float32)
    model = GBDTClassifier(num_iterations=iters, max_depth=3, device="cpu",
                           **kw).fit(Table({"features": x, "label": y}))
    return model, x, y


@pytest.fixture
def running():
    """Collects (server, query) pairs and stops every one afterwards."""
    started = []
    yield started.append
    for server, q in reversed(started):
        if q is not None:
            q.stop()
        try:
            server.stop(drain=False)
        except (OSError, AttributeError, ValueError):
            pass   # already stopped by the test


def _post(url, payload, timeout=10):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=timeout)
    return resp, json.loads(resp.read())


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


# ------------------------------------------------------------------ names
def test_names_are_the_reference_s():
    port_own = {"CLUSTER_EXCHANGES", "CLUSTER_EXCHANGE_BYTES",
                "CLUSTER_EXCHANGE"}
    consts = {k: v for k, v in vars(names).items()
              if k.isupper() and isinstance(v, str)}
    assert len(consts) > 60
    for k in sorted(consts):
        if k in port_own:
            continue
        assert getattr(ref_names, k) == consts[k], k
    for fn in ("train_step_phase", "data_pool_maps", "data_pool_map_timing",
               "quality_drift", "quality_eval"):
        assert getattr(names, fn)("x") == getattr(ref_names, fn)("x"), fn
    from mmlspark_tpu_torch.reliability import names as rnames
    assert rnames.SERVING_REQUEST_E2E == names.SERVING_REQUEST_E2E
    assert rnames.CHECKPOINT_WRITE == "checkpoint.write"


# ------------------------------------------------------------ exposition
def _observe(metrics_mod, tid=None):
    reg = metrics_mod.MetricsRegistry()
    reg.inc("serving.request.total", 7)
    reg.inc("serving.shed_requests")
    reg.set_gauge("serving.queue_depth", 3.0)
    reg.observe("data.bin_chunk", 0.25)
    rng = np.random.default_rng(10)
    for i, ms in enumerate(rng.lognormal(0.0, 1.5, size=200)):
        reg.observe_ms("serving.request.e2e", float(ms),
                       trace_id=None if tid is None else f"{tid}{i}")
    reg.observe_ms("plan.compile", 12.5)
    return reg


def test_render_prometheus_is_identical_text():
    got, want = _observe(port_metrics), _observe(ref_metrics)
    assert exposition.render_prometheus(got) == \
        ref_expo.render_prometheus(want)
    assert exposition.render_prometheus(got, windows=(30.0, 120.0)) == \
        ref_expo.render_prometheus(want, windows=(30.0, 120.0))
    # exemplars ride the OpenMetrics form; one state renders one text
    state = _observe(port_metrics, tid="t").export_state()
    assert "exemplars" in state["hists"]["serving.request.e2e"]
    assert exposition.render_prometheus(state=state, exemplars=True) == \
        ref_expo.render_prometheus(state=copy.deepcopy(state),
                                   exemplars=True)
    assert exposition.prom_name("serving.request.e2e") == \
        ref_expo.prom_name("serving.request.e2e")


def test_exports_and_merges_equal_reference():
    got, want = _observe(port_metrics), _observe(ref_metrics)
    assert got.export_state() == want.export_state()
    assert got.snapshot() == want.snapshot()
    states = [got.export_state(), _observe(port_metrics).export_state()]
    merged = exposition.merge_states(states)
    assert merged == ref_expo.merge_states(copy.deepcopy(states))
    assert exposition.state_snapshot(merged) == \
        ref_expo.state_snapshot(copy.deepcopy(merged))
    for path in ("/metrics.json", "/metrics.json?window=0",
                 "/metrics.json?window=nan"):
        g = exposition.metrics_http_response(path, registry=got)
        w = ref_expo.metrics_http_response(path, registry=want)
        assert (g[0], g[2]) == (w[0], w[2]), path
        gj, wj = json.loads(g[1]), json.loads(w[1])
        if "gauges" in wj:
            # the reference samples host and device memory gauges on a
            # scrape (telemetry/perf.py, ROADMAP Queue 1 item 23 here)
            wj["gauges"] = {k: v for k, v in wj["gauges"].items()
                            if not k.startswith(("host.", "device"))}
        assert gj == wj, path


def test_windows_and_exemplars_equal_reference():
    """Windowed shards (a fake clock drives roll-off) and exemplars of
    the same observations equal the reference's."""
    outs = []
    for metrics_mod, window_mod in ((port_metrics, window),
                                    (ref_metrics, ref_window)):
        reg = metrics_mod.MetricsRegistry(window_interval_s=1.0,
                                          window_shards=5)
        now = [100.0]
        h = reg.histogram("serving.request.e2e")
        c = reg.counter("serving.request.total")
        window_mod.set_clock(h, lambda: now[0])
        window_mod.set_clock(c, lambda: now[0])
        for step in range(8):
            now[0] = 100.0 + step
            for i in range(step + 1):
                h.observe_ms(float(2 ** i), trace_id=f"r{step}-{i}")
                c.inc()
        state = reg.window_state(3.0)
        ex = {k: v[:2] for k, v in h.exemplars().items()}   # not the wall
        outs.append((state["hists"], state["counters"], state["window_s"],
                     ex, reg.window_span_s))
    assert outs[0] == outs[1]


# -------------------------------------------------------------- quality
def _profile_cols(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(600, 4))
    return x, {**{f"f{i}": x[:, i] for i in range(4)},
               "prediction": (x[:, 0] > 0).astype(np.float64)}


def test_quality_monitor_equals_reference():
    _, cols = _profile_cols(11)
    outs = []
    for qmod in (quality, ref_quality):
        prof = qmod.DatasetProfile.fit(cols)
        mon = qmod.QualityMonitor(
            registry=(port_metrics if qmod is quality
                      else ref_metrics).MetricsRegistry())
        mon.set_reference(prof.state())
        mon.configure(sample=0.5, min_live=10)
        rng = np.random.default_rng(12)
        for b in range(5):
            feats = rng.normal(size=(40, 4)) + 0.3 * b
            preds = (feats[:, 0] > 0).astype(np.float64)
            ids = [f"req-{b}-{i}" for i in range(40)]
            mon.observe_serving(feats, preds, ids)
            for i in range(0, 40, 3):
                mon.record_label(ids[i], float(preds[i] if i % 2 else 1.0))
        reg = (port_metrics if qmod is quality
               else ref_metrics).MetricsRegistry()
        gauges = mon.refresh_gauges(reg)
        outs.append((mon.drift(), mon.export(), mon.evaluator.export(),
                     gauges, reg.snapshot()))
    assert outs[0] == outs[1]
    merged = quality.merge_quality_exports([outs[0][1], outs[0][1]])
    assert merged == ref_quality.merge_quality_exports(
        [copy.deepcopy(outs[1][1]), copy.deepcopy(outs[1][1])])


def test_streaming_evaluator_anomalies_equal_reference():
    steps = [("p", "a", 1.0), ("l", "a", 1.0), ("l", "a", 0.0),
             ("l", "b", 1.0), ("p", "b", 0.0), ("l", "c", float("nan")),
             ("p", "c", 1.0), ("l", "c", 1.0), ("p", "d", 2.0),
             ("l", "d", 300.0), ("l", "e", "text"), ("p", "f", [0.2, 0.8]),
             ("l", "f", 1.0)]
    outs = []
    for qmod, mmod in ((quality, port_metrics), (ref_quality, ref_metrics)):
        reg = mmod.MetricsRegistry()
        ev = qmod.StreamingEvaluator(registry=reg, max_pending=2,
                                     max_parked=2)
        joined = []
        ev.subscribe(lambda rid, p, lab: joined.append((rid, p, lab)))
        verdicts = [ev.record_prediction(rid, v) if kind == "p"
                    else ev.record_label(rid, v) for kind, rid, v in steps]
        for i in range(4):   # age predictions out of the bounded window
            ev.record_prediction(f"old{i}", 1.0)
        verdicts.append(ev.record_label("old0", 1.0))
        outs.append((verdicts, joined, ev.export(), reg.snapshot()))
    assert outs[0] == outs[1]


# ------------------------------------------------------- version registry
def _normalise(export, ids):
    """A /versions export with version ids, digests and install times
    replaced by placeholders."""
    text = json.dumps(export, sort_keys=True, default=str)
    for i, vid in enumerate(ids):
        text = text.replace(vid, f"<v{i}>")
    out = json.loads(text)
    for entry in out["versions"].values():
        for key in ("fingerprint", "content_digest", "installed_at",
                    "lineage"):
            entry.pop(key, None)
    return out


def test_version_registry_exports_equal_up_to_ids():
    exports = []
    for lin, mmod in ((lineage, port_metrics), (ref_lineage, ref_metrics)):
        reg = lin.VersionRegistry()
        metrics = mmod.MetricsRegistry()
        ids = []
        for k in range(3):
            mv = lin.ModelVersion(version=f"{lin.__name__[:12]}{k}",
                                  fingerprint=f"fp{k}",
                                  content_digest=f"cd{k}",
                                  lineage={"k": k})
            ids.append(mv.version)
            swap = reg.install(mv, metrics=metrics)
            assert swap["new"] == mv.version
            for j in range(10 + k):
                reg.observe(mv.version, float(1 + j % 4 + k),
                            rows=2, errors=int(j % 5 == 0))
        reg.observe("unknown", 1.0)
        gauges = mmod.MetricsRegistry()
        canary = reg.refresh_canary_gauges(gauges)
        exports.append((_normalise(reg.export(), ids),
                        json.loads(json.dumps(canary).replace(ids[1], "<v1>")
                                   .replace(ids[2], "<v2>")),
                        gauges.snapshot(), metrics.snapshot()))
    assert exports[0] == exports[1]
    assert len(exports[0][0]["versions"]) == 2   # bounded: two slots


def test_model_version_two_digest_contract():
    a, _, _ = _fit(seed=0)
    b, _, _ = _fit(seed=1)
    mva, mvb = lineage.model_version(a), lineage.model_version(b)
    assert mva.content_digest and mvb.content_digest
    assert mva.content_digest != mvb.content_digest
    assert mva.version != mvb.version
    assert mva.version == mva.content_digest[:12]
    assert lineage.model_version(a).version == mva.version
    sa = lineage.model_version(a, content=False)
    assert sa.content_digest is None
    assert sa.version == sa.fingerprint[:12]
    exported = mva.export()
    json.dumps(exported)
    assert exported["lineage"]["estimator"] == "GBDTClassifier"


def test_run_ledger_append_records_and_torn_line(tmp_path):
    path = tmp_path / "ledger.jsonl"
    ledger = lineage.RunLedger(str(path))
    assert ledger.records() == []
    ledger.append({"version": "aaa", "step": 1})
    ledger.append_event("deploy", version="bbb")
    with open(path, "ab") as f:
        f.write(b'{"version": "ccc", "st')
    recs = ledger.records()
    assert [r.get("version") for r in recs] == ["aaa", "bbb"]
    assert recs[1]["event"] == "deploy"
    assert lineage.configure_run_ledger(str(path)) is not None
    assert lineage.get_run_ledger().path == str(path)
    lineage.configure_run_ledger(None)
    assert lineage.get_run_ledger() is None


def test_gbdt_fit_stamps_lineage_and_journals_ledger(tmp_path):
    lineage.configure_run_ledger(str(tmp_path / "runs.jsonl"))
    model, _, _ = _fit(seed=0, checkpoint_dir=str(tmp_path / "ckpt"),
                       checkpoint_interval=2)
    rec = model.lineage
    assert rec["estimator"] == "GBDTClassifier"
    assert rec["uid"]
    assert rec["params"]["num_iterations"] == 4
    assert len(rec["reference_profile"]) == 12
    assert rec["checkpoint_step"] is not None
    json.dumps(rec)
    entries = lineage.get_run_ledger().records()
    assert len(entries) == 1
    assert entries[0]["version"] == lineage.model_version(model).version


def test_left_out_watch_rules_name_their_item():
    with pytest.raises(NotImplementedError, match="item 27"):
        lineage.canary_watch_rules()
    with pytest.raises(NotImplementedError, match="item 27"):
        quality.quality_watch_rules()


# ------------------------------------------------------------- hot-swap
def test_hot_swap_under_load_drops_zero_requests(running):
    model_a, _, _ = _fit(seed=0, n=800)
    model_b, _, _ = _fit(seed=1, n=800)
    server, q = serving.serve_pipeline(model_a, ["features"],
                                       mode="microbatch", max_batch=64)
    running((server, q))
    host, port = server._httpd.server_address[:2]
    body = json.dumps({"features": [0.5] * 5})
    transform = q.transform_fn
    versions = []
    lock = threading.Lock()

    def client():
        conn = http.client.HTTPConnection(host, port, timeout=10)
        try:
            for _ in range(40):
                conn.request("POST", "/", body=body)
                resp = conn.getresponse()
                resp.read()
                with lock:
                    versions.append((resp.status,
                                     resp.getheader("X-Model-Version")))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(6)]
    for th in threads:
        th.start()
    deadline = time.monotonic() + 10.0
    while (reliability_metrics.get(names.SERVING_REQUEST_TOTAL) < 20
           and time.monotonic() < deadline):
        time.sleep(0.002)
    old = transform.version
    swap = transform.install_model(model_b)
    for th in threads:
        th.join(timeout=30)
    assert len(versions) == 6 * 40
    assert {s for s, _ in versions} == {200}
    assert {v for _, v in versions} <= {old, swap["new"]}
    assert any(v == old for _, v in versions)
    assert transform.version == swap["new"] != old
    assert reliability_metrics.get(names.SERVING_MODEL_SWAPS) == 1
    assert reliability_metrics.get(names.SERVING_MODEL_SWAP_ERRORS) == 0
    status, _, payload = _get(server.address + "/versions")
    exp = json.loads(payload)
    assert status == 200 and exp["current"] == swap["new"]
    assert set(exp["versions"]) == {old, swap["new"]}
    # every request is counted in the split of the version that scored
    # it (a batch that read the old handle before the commit lands in the
    # incumbent's, after its frozen baseline was taken)
    counts = {v: e["metrics"]["counters"][names.SERVING_REQUEST_TOTAL]
              for v, e in exp["versions"].items()}
    assert sum(counts.values()) == 6 * 40
    assert counts[old] > 0
    # and the closed-loop harness drops nothing on the new version
    res = run_load(host, port, body, n_clients=4, per_client=25,
                   timeout=10)
    assert not res.errors and res.n_dropped == 0 and res.n_ok == 100


def test_hot_swap_old_plans_drain_new_version_stamps():
    model_a, _, _ = _fit(seed=0)
    model_b, _, _ = _fit(seed=1)
    transform = plan.compile_serving_transform(model_a, ["features"],
                                               max_plans=2)
    body = [json.dumps({"features": [0.1] * 5}).encode()]
    out = transform(body * 3)
    old_plan = transform._plan_for(3)
    old_version = transform.version
    assert out[0].version == old_version
    swap = transform.install_model(model_b)
    assert swap["old"] == old_version and swap["new"] != old_version
    assert transform.stats()["stale_plans"] == 1
    out = transform(body * 3)
    assert out[0].version == swap["new"]
    transform(body * 5)
    stats = transform.stats()
    assert stats["stale_plans"] == 0, stats
    assert stats["evictions"] >= 1
    assemble, run = old_plan
    assert len(run(assemble([{"features": [0.1] * 5}] * 3))) == 3
    assert reliability_metrics.get(names.PLAN_RECOMPILES) == 0


def test_hot_swap_clears_stale_drift_gauges_and_swaps_reference():
    model_a, _, _ = _fit(seed=0)
    model_b, _, _ = _fit(seed=1)
    transform = plan.compile_serving_transform(model_a, ["features"])
    mon = quality.get_monitor()
    assert mon.active
    mon.configure(sample=1.0, min_live=8)
    shifted = (np.random.default_rng(3).normal(size=(32, 5))
               + 5.0).astype(np.float32)
    transform([json.dumps({"features": [float(v) for v in row]}).encode()
               for row in shifted])
    quality.refresh_quality_gauges()
    assert reliability_metrics.peek_gauge(names.QUALITY_DRIFT_MAX) is not None
    transform.install_model(model_b)
    assert reliability_metrics.peek_gauge(names.QUALITY_DRIFT_MAX) is None
    assert quality.get_monitor().active


def test_chaos_failed_swap_rolls_back_to_incumbent(running):
    inj = FaultInjector(seed=1337, rules=[
        {"site": "serving.swap", "kind": "error", "at": [0]}])
    model_a, x, _ = _fit(seed=0)
    model_b, _, _ = _fit(seed=1)
    server, q = serving.serve_pipeline(model_a, ["features"], faults=inj)
    running((server, q))
    transform = q.transform_fn
    incumbent = transform.version
    with pytest.raises(InjectedFault):
        transform.install_model(model_b)
    assert transform.version == incumbent
    assert reliability_metrics.get(names.SERVING_MODEL_SWAP_ERRORS) == 1
    assert reliability_metrics.get(names.SERVING_MODEL_SWAPS) == 0
    resp, reply = _post(server.address,
                        {"features": [float(v) for v in x[0]]})
    assert resp.status == 200 and "prediction" in reply
    assert resp.headers["X-Model-Version"] == incumbent
    status, _, payload = _get(server.address + "/versions")
    assert list(json.loads(payload)["versions"]) == [incumbent]
    swap = transform.install_model(model_b)
    assert transform.version == swap["new"] != incumbent


@pytest.mark.parametrize("transport", TRANSPORTS)
def test_x_model_version_header_on_both_transports(running, transport):
    model, x, _ = _fit(seed=0)
    transform = plan.compile_serving_transform(model, ["features"])
    server = serving.ServingServer(num_partitions=1,
                                   transport=transport).start()
    q = serving.ServingQuery(server, transform, mode="continuous").start()
    running((server, q))
    resp, reply = _post(server.address,
                        {"features": [float(v) for v in x[0]]})
    assert "prediction" in reply
    assert resp.headers["X-Model-Version"] == transform.version
    assert resp.headers["X-Request-Id"]
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server.address, {"wrong": 1})
    assert err.value.code == 400
    assert err.value.headers["X-Model-Version"] == transform.version


# ---------------------------------------------------- exposition over HTTP
@pytest.mark.parametrize("transport", TRANSPORTS)
def test_exposition_paths_answer(running, transport):
    model, x, _ = _fit(seed=0)
    transform = plan.compile_serving_transform(model, ["features"])
    server = serving.ServingServer(num_partitions=1,
                                   transport=transport).start()
    q = serving.ServingQuery(server, transform, mode="continuous").start()
    running((server, q))
    for row in x[:5]:
        _post(server.address, {"features": [float(v) for v in row]})
    status, headers, body = _get(server.address + "/metrics")
    assert status == 200
    assert headers["Content-Type"] == exposition.PROM_CONTENT_TYPE
    assert b"serving_request_e2e_seconds_bucket" in body
    status, _, body = _get(server.address + "/metrics.json?window=30")
    state = json.loads(body)
    assert status == 200 and state["window_s"] == 30.0
    assert state["counters"]["serving.request.total"] == 5
    status, _, body = _get(server.address + "/quality")
    assert status == 200 and json.loads(body)["active"] is True
    status, _, body = _get(server.address + "/versions")
    assert status == 200
    assert json.loads(body)["current"] == transform.version
    status, _, body = _get(server.address + "/metrics.json?window=-1")
    assert status == 400
    for path, item in (("/slo", "item 27"), ("/debug/bundle", "item 23"),
                       ("/debug/profile?ms=5", "item 23")):
        status, headers, body = _get(server.address + path)
        assert status == 501, path
        assert headers["Content-Type"] == "application/json"
        assert item in json.loads(body)["error"], (path, body)
    # exposition is never counted as traffic
    assert reliability_metrics.get(names.SERVING_REQUEST_TOTAL) == 5
    req = urllib.request.Request(server.address + "/metrics.json",
                                 data=b"{}", method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert r.status == 200


def test_left_out_telemetry_names_their_item():
    import mmlspark_tpu_torch.telemetry as tel
    for name, item in (("SLOEngine", "item 27"), ("FlightRecorder",
                                                  "item 23"),
                       ("TelemetryWatcher", "item 27")):
        with pytest.raises(NotImplementedError, match=item.replace(
                "(", r"\(").replace(")", r"\)")):
            getattr(tel, name)
    with pytest.raises(NotImplementedError, match="item 23"):
        perf.AotCache   # noqa: B018
    with pytest.raises(NotImplementedError, match="item 24"):
        plan.serving_plan_contract   # noqa: B018
    assert tel.render_prometheus is exposition.render_prometheus


# ------------------------------------------------------ spans and tracing
def test_span_ids_and_sampling_equal_reference():
    ids = [f"{i:08x}-{i * 7}" for i in range(200)]
    for rate in (0.0, 0.01, 0.3, 1.0):
        assert [spans.head_sampled(t, rate) for t in ids] == \
            [ref_spans.head_sampled(t, rate) for t in ids]
    for value in ("abc", "abc:def:1", "abc:def:0", "abc:def", ""):
        got = spans.parse_trace_header(value)
        want = ref_spans.parse_trace_header(value)
        assert (got is None and want is None) or tuple(got) == tuple(want)
    assert spans.TRACE_HEADER == ref_spans.TRACE_HEADER == "X-Trace-Id"
    assert ref_telemetry.REQUEST_ID_HEADER == spans.REQUEST_ID_HEADER


def test_sampled_request_traces_the_worker_hop(running, tmp_path):
    spans.configure(sample=1.0)
    tracer = spans.get_tracer()
    tracer.clear()
    model, x, _ = _fit(seed=0)
    server, q = serving.serve_pipeline(model, ["features"])
    running((server, q))
    resp, _ = _post(server.address, {"features": [float(v) for v in x[0]]})
    rid = resp.headers["X-Request-Id"]
    deadline = time.monotonic() + 5
    while (not tracer.finished(names.SERVING_REQUEST_SPAN)
           and time.monotonic() < deadline):
        time.sleep(0.01)
    by_name = {s["name"]: s for s in tracer.finished()}
    root = by_name[names.SERVING_REQUEST_SPAN]
    assert root["trace_id"] == rid == root["span_id"]
    assert root["attrs"]["status"] == 200
    hop = by_name[names.SERVING_PARTITION_TRANSFORM_SPAN]
    assert hop["trace_id"] == rid and hop["parent_id"] == rid
    assert by_name[names.SERVING_PLAN_RUN_SPAN]["trace_id"] == rid
    assert by_name[names.PLAN_COMPILE_SPAN]["trace_id"] == rid
    path = str(tmp_path / "spans.jsonl")
    n = tracer.export_jsonl(path)
    assert [s["name"] for s in spans.read_jsonl(path)] == \
        [s["name"] for s in tracer.finished()][:n]
    # a propagated X-Trace-Id joins its trace
    req = urllib.request.Request(
        server.address, data=json.dumps(
            {"features": [float(v) for v in x[1]]}).encode(),
        headers={spans.TRACE_HEADER: "feedbeef:0123:1"})
    with urllib.request.urlopen(req, timeout=10) as r:
        r.read()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and not any(
            s["trace_id"] == "feedbeef"
            for s in tracer.finished(names.SERVING_REQUEST_SPAN)):
        time.sleep(0.01)
    assert any(s["trace_id"] == "feedbeef" and s["parent_id"] == "0123"
               for s in tracer.finished(names.SERVING_REQUEST_SPAN))


def test_compile_log_records_builds_and_recompiles():
    log = perf.CompileLog(max_keys=2)
    reg = port_metrics.MetricsRegistry()
    log.record("fp", 4, 0.01, registry=reg)
    with tracing.annotate("region-a"):
        rec = log.record("fp", 8, 0.02, registry=reg)
    assert rec["region"] == "region-a"
    assert tracing.current_region() is None
    again = log.record("fp", 4, 0.03, registry=reg)
    assert again["recompile"] is True and again["count"] == 2
    assert log.stats()["compiles"] == 3 and log.stats()["recompiles"] == 1
    assert reg.get(names.PLAN_COMPILES) == 3
    assert reg.get(names.PLAN_RECOMPILES) == 1
    assert reg.snapshot()["plan.compile.count"] == 3
    assert set(log.per_key()) == {"fp@4", "fp@8"}
    assert perf.compile_stats() == perf.get_compile_log().stats()


def test_trace_writes_a_profile(tmp_path):
    spans.configure(sample=1.0)
    out = str(tmp_path / "trace")
    with tracing.trace(out):
        with tracing.annotate("matmul-region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(os.path.join(out, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert "matmul-region" in f.read()
    assert spans.get_tracer().finished(names.DEVICE_PROFILE_SPAN)
    with pytest.raises(NotImplementedError, match="item 23"):
        with tracing.trace(out, create_perfetto_link=True):
            pass


def test_wall_clock_routes_to_sink_tracer_or_print(capsys):
    seen = []
    with tracing.wall_clock("data.bin_chunk", sink=lambda *a: seen.append(a)):
        pass
    assert seen and seen[0][0] == "data.bin_chunk"
    spans.configure(sample=1.0)
    with tracing.wall_clock("data.bin_chunk", tracer=True):
        pass
    assert spans.get_tracer().finished("data.bin_chunk")
    spans.configure(sample=0.0)
    with tracing.wall_clock("data.bin_chunk", tracer=True):
        pass
    assert "data.bin_chunk:" in capsys.readouterr().out


# ------------------------------------------------------------ train.metrics
def _same(a: dict, b: dict) -> bool:
    """Metric dicts equal value for value, NaN equal to NaN."""
    return json.dumps(a, sort_keys=True, default=float) == \
        json.dumps(b, sort_keys=True, default=float)


def test_train_metrics_equal_reference():
    rng = np.random.default_rng(13)
    y = rng.integers(0, 3, size=300)
    p = np.where(rng.uniform(size=300) < 0.7, y, rng.integers(0, 3, 300))
    scores = rng.uniform(size=300)
    yb = (scores + rng.normal(size=300) * 0.3 > 0.5).astype(int)
    yr = rng.normal(size=300) * 5 + 1e6
    pr = yr + rng.normal(size=300)
    for mod_pair in ((train_metrics, ref_train_metrics),):
        got, want = mod_pair
        g, w = got.multiclass_metrics(y, p), want.multiclass_metrics(y, p)
        assert _same(g[0], w[0])   # AUC is NaN in both: batch-only
        np.testing.assert_array_equal(g[1], w[1])
        g, w = got.binary_metrics(yb, scores), want.binary_metrics(yb, scores)
        assert _same(g[0], w[0])
        assert got.regression_metrics(yr, pr) == \
            want.regression_metrics(yr, pr)
        chunks = [got.RegressionState.from_arrays(yr[i:i + 70], pr[i:i + 70])
                  for i in range(0, 300, 70)]
        acc = chunks[0]
        for c in chunks[1:]:
            acc.merge(c)
        whole = want.RegressionState.from_arrays(yr, pr)
        for k, v in whole.metrics().items():
            assert acc.metrics()[k] == pytest.approx(v, rel=1e-9), k
        cs = got.ConfusionState.from_arrays(y[:100], p[:100]).merge(
            got.ConfusionState.from_arrays(y[100:], p[100:]))
        assert cs.state() == want.ConfusionState.from_arrays(y, p).state()
        assert got.ndcg_at_k([y[:20]], [scores[:20]]) == \
            want.ndcg_at_k([y[:20]], [scores[:20]])
