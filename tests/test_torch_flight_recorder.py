"""Port parity: the flight recorder, the debug endpoints, the first-call
analysis and the resource gauges (`mmlspark_tpu_torch.telemetry.perf`,
`exposition`) against the reference's, JAX on the CPU.

- one seeded sequence of SLO verdicts through both packages'
  `FlightRecorder` (with and without the rate limit) gives the same dump
  decisions, bundle names, bundle files and manifest keys;
- `/debug/bundle` and `/debug/profile` answer the same status codes
  through both packages' handlers: 503 disabled, 400 malformed, 200 then
  429, 500 on an unwritable directory;
- an SLO burn dumps one bundle, staying burning none; a watcher trip
  notifies the process recorder; a newly flagged straggler calls the
  profile session once, as the reference's detector does;
- the Perfetto link is served and fetched over localhost;
- `executable_analysis` / `AotCache` / `collective_traffic` keep the
  reference's contracts (fields absent when unknown, never raising, one
  record per signature, the collective counters), and the resource
  gauges on the CPU are the reference's keys.
"""
import json
import logging
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu.reliability import metrics as ref_metrics
from mmlspark_tpu.telemetry import exposition as ref_expo
from mmlspark_tpu.telemetry import goodput as ref_goodput
from mmlspark_tpu.telemetry import names as ref_names
from mmlspark_tpu.telemetry import perf as ref_perf
from mmlspark_tpu.telemetry import profiler as ref_prof
from mmlspark_tpu_torch.reliability import metrics as port_metrics
from mmlspark_tpu_torch.telemetry import (exposition, goodput, names, perf,
                                          profiler, slo, watch)
from mmlspark_tpu_torch.utils import tracing

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)


def _bundle_name(path):
    """bundle-<pid>-<seq>-<tag> without the pid."""
    parts = os.path.basename(path).split("-", 2)
    return parts[0] + "-" + parts[2]


def _run_verdicts(mod, metrics_mod, tmp, seq, min_interval_s):
    reg = metrics_mod.MetricsRegistry()
    rec = mod.FlightRecorder(bundle_dir=str(tmp),
                             min_interval_s=min_interval_s, max_bundles=32,
                             registry=reg)
    out = []
    for burning, source in seq:
        m = rec.on_verdict({"burning": burning, "ok": not burning},
                           source=source)
        out.append(None if m is None else (
            _bundle_name(m["path"]), tuple(m["files"]), tuple(sorted(m)),
            m["burning"]))
    c = reg.export_state()["counters"]
    return out, (c.get(names.TELEMETRY_BUNDLE_DUMPS, 0),
                 c.get(names.TELEMETRY_BUNDLE_SUPPRESSED, 0))


@pytest.mark.parametrize("seed, min_interval_s", [(0, 0.0), (1, 0.0),
                                                  (2, 3600.0)])
def test_verdict_sequence_dumps_as_reference(tmp_path, seed, min_interval_s):
    rng = np.random.default_rng(seed)
    seq = [(bool(b), str(s)) for b, s in zip(
        rng.random(16) < 0.6, rng.choice(["local", "fleet"], 16))]
    got, got_n = _run_verdicts(perf, port_metrics, tmp_path / "port", seq,
                               min_interval_s)
    want, want_n = _run_verdicts(ref_perf, ref_metrics, tmp_path / "ref",
                                 seq, min_interval_s)
    assert got == want
    assert got_n == want_n
    assert sum(m is not None for m in got) >= 1
    files = next(m[1] for m in got if m is not None)
    assert files == ("spans.jsonl", "pending.jsonl", "metrics.json",
                     "metrics_window.json", "slo.json", "compiles.json",
                     "memory.json", "goodput.json", "roofline.json",
                     "quality.json", "versions.json", "manifest.json")
    kept = sorted(os.listdir(tmp_path / "port"))
    assert [_bundle_name(k) for k in kept] == sorted(
        m[0] for m in got if m is not None)
    for k in kept:
        assert sorted(os.listdir(tmp_path / "port" / k)) == sorted(files)


def test_failed_dump_rolls_back_as_reference(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    for mod in (perf, ref_perf):
        rec = mod.FlightRecorder(bundle_dir=str(blocker / "sub"),
                                 min_interval_s=3600.0)
        with pytest.raises(OSError):
            rec.dump("boom")
        assert rec._last_dump is None
        rec.configure(bundle_dir=str(tmp_path / mod.__name__))
        assert rec.dump("after") is not None


# ------------------------------------------------------- /debug handlers
@pytest.fixture
def defaults_restored():
    """The process-default recorder and session of both packages, left
    disabled and with free rate-limit slots."""
    objs = (perf.get_flight_recorder(), ref_perf.get_flight_recorder(),
            profiler.get_profile_session(), ref_prof.get_profile_session())

    def reset():
        for o in objs:
            if hasattr(o, "bundle_dir"):
                o.configure(bundle_dir="", min_interval_s=60.0)
                o._last_dump = None
                o._burn_state.clear()
            else:
                o.configure(profile_dir="", min_interval_s=60.0)
                o._last = None
    reset()
    yield objs
    reset()


def _statuses(handler, path, configure, tmp):
    out = []
    out.append(handler(path)[0])                 # disabled
    configure(str(tmp))
    out.append(handler(path)[0])                 # 200
    out.append(handler(path)[0])                 # 429
    blocker = tmp.parent / (tmp.name + ".file")
    blocker.write_text("x")
    configure(str(blocker / "sub"), 0.0)
    out.append(handler(path)[0])                 # 500
    return out


@pytest.mark.parametrize("path", ["/debug/bundle", "/debug/profile?ms=2"])
def test_debug_status_codes_equal_reference(tmp_path, path,
                                            defaults_restored):
    rec, rrec, sess, rsess = defaults_restored
    if path.startswith("/debug/bundle"):
        def conf(o):
            return lambda d, i=60.0: o.configure(bundle_dir=d,
                                                 min_interval_s=i)
        got = _statuses(exposition.metrics_http_response, path, conf(rec),
                        tmp_path / "port")
        want = _statuses(ref_expo.metrics_http_response, path, conf(rrec),
                         tmp_path / "ref")
    else:
        def conf(o):
            return lambda d, i=60.0: o.configure(profile_dir=d,
                                                 min_interval_s=i)
        got = _statuses(exposition.metrics_http_response, path, conf(sess),
                        tmp_path / "port")
        want = _statuses(ref_expo.metrics_http_response, path, conf(rsess),
                         tmp_path / "ref")
    assert got == want == [503, 200, 429, 500]


@pytest.mark.parametrize("query", ["?ms=-1", "?ms=abc", "?ms=nan"])
def test_debug_profile_rejects_malformed_ms(query, defaults_restored):
    got = exposition.metrics_http_response("/debug/profile" + query)
    want = ref_expo.metrics_http_response("/debug/profile" + query)
    assert got[0] == want[0] == 400
    assert json.loads(got[1]) == json.loads(want[1])


# ---------------------------------------------------- the burn triggers
def test_slo_burn_dumps_once(tmp_path, defaults_restored):
    rec = defaults_restored[0]
    rec.configure(bundle_dir=str(tmp_path), min_interval_s=0.0)
    reg = port_metrics.MetricsRegistry()
    for ms in (5.0, 7.0, 9.0):
        reg.observe_ms(names.SERVING_REQUEST_E2E, ms)

    def engine(threshold_ms):
        return slo.SLOEngine(objectives=[slo.Objective(
            name="burn", kind=slo.LATENCY, metric=names.SERVING_REQUEST_E2E,
            threshold_ms=threshold_ms, quantile=50.0)], registry=reg)
    tight, loose = engine(1e-3), engine(1e6)
    assert tight.verdict()["burning"]
    assert len(os.listdir(tmp_path)) == 1
    assert tight.verdict()["burning"]
    assert tight.verdict(notify=False)["burning"]
    assert len(os.listdir(tmp_path)) == 1      # staying burning: no dump
    assert not loose.verdict()["burning"]      # the incident is over
    tight.verdict()
    assert len(os.listdir(tmp_path)) == 2      # a new burn dumps again
    with open(os.path.join(tmp_path, sorted(os.listdir(tmp_path))[0],
                           "manifest.json")) as f:
        assert json.load(f)["reason"] == "slo-burn"


def test_watcher_trip_notifies_the_process_recorder(tmp_path,
                                                   defaults_restored):
    rec = defaults_restored[0]
    rec.configure(bundle_dir=str(tmp_path), min_interval_s=0.0)
    w = watch.TelemetryWatcher(rules=[watch.WatchRule(
        key="serving.request.e2e.p99", max_value=100.0, min_samples=1)],
        registry=port_metrics.MetricsRegistry())
    assert w.check(series={"serving.request.e2e.p99": [(0.0, 250.0)]})
    (only,) = os.listdir(tmp_path)
    assert only.endswith("-watch-serving-request-e2e-p99")
    w.check(series={"serving.request.e2e.p99": [(1.0, 260.0)]})
    assert len(os.listdir(tmp_path)) == 1      # still tripped: latched
    w.check(series={"serving.request.e2e.p99": [(2.0, 10.0)]})
    w.check(series={"serving.request.e2e.p99": [(3.0, 300.0)]})
    assert len(os.listdir(tmp_path)) == 2      # recovered, tripped again


class _Heartbeat:
    def __init__(self, process_id, p50s):
        self.process_id = process_id
        self.rows = [{"process_id": i, "stats": {"step_p50_ms": v,
                                                 "steps": 8}}
                     for i, v in enumerate(p50s)]

    def read_all(self, max_age_s=None):
        return self.rows


class _Session:
    def __init__(self):
        self.calls = []

    def capture(self, ms=None, reason="on-demand", force=False):
        self.calls.append(reason)
        return {"reason": reason}


@pytest.mark.parametrize("own", [0, 1])
def test_flagged_straggler_captures_once_as_reference(own, monkeypatch):
    calls = {}
    for pkg, gmod, pmod, mmod in (("port", goodput, profiler, port_metrics),
                                  ("ref", ref_goodput, ref_prof,
                                   ref_metrics)):
        fake = _Session()
        monkeypatch.setattr(pmod, "get_profile_session", lambda f=fake: f)
        det = gmod.StragglerDetector(_Heartbeat(own, [10.0, 100.0, 10.0]),
                                     registry=mmod.MetricsRegistry())
        for _ in range(3):
            rows = det.check()
            assert [r["process_id"] for r in rows] == [1]
        calls[pkg] = fake.calls
    assert calls["port"] == calls["ref"] == (["straggler"] if own == 1
                                             else [])


# ------------------------------------------------------- the Perfetto link
def test_perfetto_link_is_served_and_fetched(tmp_path, monkeypatch):
    monkeypatch.setattr(profiler, "PERFETTO_TIMEOUT_S", 30.0)
    fetched = {}

    class _Fetch(logging.Handler):
        def emit(self, record):
            url = record.getMessage().rsplit("url=", 1)[1]

            def get():
                with urllib.request.urlopen(url, timeout=10) as r:
                    fetched["status"] = r.status
                    fetched["cors"] = r.headers[
                        "Access-Control-Allow-Origin"]
                    fetched["body"] = json.loads(r.read())
            fetched["thread"] = threading.Thread(target=get, daemon=True)
            fetched["thread"].start()

    handler = _Fetch()
    profiler.logger.addHandler(handler)
    try:
        with profiler.ProfileSession().session(
                reason="trace", log_dir=str(tmp_path), force=True,
                create_perfetto_link=True) as info:
            torch.ones(8, 8) @ torch.ones(8, 8)
    finally:
        profiler.logger.removeHandler(handler)
    assert info["perfetto"]["fetched"]
    fetched["thread"].join(timeout=10)
    assert info["perfetto"]["link"].startswith(
        "https://ui.perfetto.dev/#!/?url=http://127.0.0.1:")
    assert fetched["status"] == 200
    assert fetched["cors"] == "https://ui.perfetto.dev"
    assert "traceEvents" in fetched["body"]
    # the explicit API: the same session path, the trace in log_dir
    with tracing.trace(str(tmp_path / "t")):
        pass
    assert any(n.endswith(".pt.trace.json")
               for n in os.listdir(tmp_path / "t"))


# ------------------------------------------- analysis, AotCache, gauges
def test_executable_analysis_fields_and_never_raises():
    a = torch.ones(16, 32)
    b = torch.ones(32, 8)
    got = perf.executable_analysis(lambda x, y: x @ y, a, b)
    assert got == {"flops": 2.0 * 16 * 32 * 8}   # no card: no peak_bytes
    assert perf.executable_analysis(lambda x: x.sum() + 1, a) == {}

    def fails(x):
        raise ValueError("boom")
    assert perf.executable_analysis(fails, a) == {}


def test_aot_cache_records_one_compile_per_signature():
    log = perf.CompileLog()
    reg = port_metrics.MetricsRegistry()
    step = perf.AotCache(lambda x: x @ x.T, label="test.step", log=log,
                         registry=reg, max_entries=2)
    for shape in ((4, 3), (4, 3), (5, 3), (6, 3), (4, 3)):
        out = step(torch.ones(shape))
        assert out.shape == (shape[0], shape[0])
    recs = log.records()
    assert [r["bucket"] for r in recs] == ["4x3", "5x3", "6x3", "4x3"]
    assert [r["recompile"] for r in recs] == [False, False, False, True]
    assert recs[0]["analysis"] == {"flops": 2.0 * 4 * 3 * 4}
    assert recs[0]["label"] == "test.step"
    counters = reg.export_state()["counters"]
    assert counters[names.PLAN_COMPILES] == 4
    assert counters[names.PLAN_RECOMPILES] == 1
    fn = perf.compile_with_analysis(lambda x: x * 2, torch.ones(3),
                                    label="test.double", log=log)
    assert fn(torch.ones(3)).tolist() == [2.0, 2.0, 2.0]
    assert log.records()[-1]["bucket"] == "3"


def _comm(name, dims, dtype):
    return {"ph": "X", "cat": "user_annotation", "name": name,
            "args": {"Input Dims": dims, "Input type": dtype}}


def test_collective_traffic_from_a_capture():
    trace = {"traceEvents": [
        _comm("gloo:all_reduce", [[1000]], ["float"]),
        _comm("gloo:all_reduce", [[10, 10]], ["c10::BFloat16"]),
        _comm("gloo:all_gather", [[1000]], ["float"]),
        _comm("nccl:reduce_scatter", [[64]], ["double"]),
        _comm("gloo:broadcast", [[3]], ["long int"]),
        {"ph": "X", "cat": "cpu_op", "name": "c10d::allreduce_",
         "args": {}}]}
    assert perf.collective_traffic(trace) == {
        "all-reduce": {"ops": 2, "bytes": 4000 + 200},
        "all-gather": {"ops": 1, "bytes": 4000},
        "reduce-scatter": {"ops": 1, "bytes": 512},
        "broadcast": {"ops": 1, "bytes": 24}}
    only_ops = {"traceEvents": [{"ph": "X", "cat": "cpu_op",
                                 "name": "c10d::allgather_", "args": {}}]}
    assert perf.collective_traffic(only_ops) == {
        "all-gather": {"ops": 1, "bytes": 0}}
    assert set(perf.COLLECTIVE_KINDS) == set(ref_perf.COLLECTIVE_KINDS)


def test_collective_counters_equal_reference():
    analysis = {"collectives": {"all-reduce": {"ops": 3, "bytes": 1200},
                                "all-gather": {"ops": 1, "bytes": 64}}}
    states = []
    for mod, mmod in ((perf, port_metrics), (ref_perf, ref_metrics)):
        reg = mmod.MetricsRegistry()
        mod.CompileLog(registry=reg).record("fp", "8x8", 0.01,
                                            analysis=analysis)
        states.append(reg.export_state()["counters"])
    assert states[0] == states[1]
    assert states[0][names.PLAN_COLLECTIVE_BYTES] == 1264


def test_resource_gauges_on_the_cpu_are_the_reference_keys():
    got = perf.sample_resource_stats()
    assert got["host_rss_bytes"] > 0 and got["devices"] == []
    preg, rreg = port_metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    perf.sample_resource_gauges(preg)
    ref_perf.sample_resource_gauges(rreg)
    assert sorted(preg.export_state()["gauges"]) == sorted(
        rreg.export_state()["gauges"]) == [names.HOST_RSS_BYTES]
    assert names.HOST_RSS_BYTES == ref_names.HOST_RSS_BYTES
    for v in (0.0, 1.5e11, 3.3e12):
        assert perf.hbm_utilization(v, 3350.0) == \
            ref_perf.hbm_utilization(v, 3350.0)
    assert perf.hbm_utilization(1.0, None) == 0.0


_GLOO_ANALYSIS = """
import json, socket, sys
import torch
import torch.distributed as dist
sys.path.insert(0, {repo!r})
from mmlspark_tpu_torch.telemetry import perf
s = socket.socket()
s.bind(("localhost", 0))
port = s.getsockname()[1]
s.close()
dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                        world_size=1, rank=0)

def step(t):
    dist.all_reduce(t)
    dist.all_gather([torch.empty_like(t)], t)
    return t

print(json.dumps(perf.executable_analysis(step, torch.ones(1000))))
dist.destroy_process_group()
"""


def test_executable_analysis_counts_a_process_group_s_collectives():
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _GLOO_ANALYSIS.format(repo=repo)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"collectives": {"all-reduce": {"ops": 1, "bytes": 4000},
                                   "all-gather": {"ops": 1, "bytes": 4000}}}
