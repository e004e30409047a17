"""Port parity: distributed serving and the fleet scrape.

- The reference's scenario of `tests/test_multiprocess.py:201-245` over
  two gloo processes on the CPU (`file://` rendezvous in `tmp_path`):
  `start_distributed_serving` on both ranks, the leader's registry, a
  `RegistryClient` on rank 0 round-robining requests over both ranks'
  servers, and an injected worker death on rank 1 healed by epoch
  replay. Each rank serves a SAR model's id-keyed plan (`device="cpu"`)
  through the compiled transform. Then `scrape_cluster(versions=True)`
  merges both ranks' request counts, an `install_model` on rank 1 alone
  shows as two versions of one worker each (`rollout_skew`), and a
  SIGTERM of rank 1 under the port's `drain_on_signal` takes its entry
  out of the registry (the stopping server unregisters itself) while the
  client fails over and answers; the leader's end drives
  `drain_on_signal(registries=)`.
- `merge_version_exports` and `rollout_skew` equal the reference's on
  the same exports, and `scrape_cluster(versions=True)` of a port fleet
  equals the reference's scrape of a reference fleet serving the same
  model, up to the version ids (the packages' digests differ by design).
"""
import json
import os
import subprocess
import sys
import textwrap
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import Table as RefTable
from mmlspark_tpu.io import registry as ref_registry
from mmlspark_tpu.io import serving as ref_serving
from mmlspark_tpu.reliability.metrics import \
    reliability_metrics as ref_metrics
from mmlspark_tpu.telemetry import exposition as ref_exposition
from mmlspark_tpu.telemetry import lineage as ref_lineage
from mmlspark_tpu.telemetry import quality as ref_quality
from mmlspark_tpu.workloads import IsolationForestScorer as RefScorer
from mmlspark_tpu_torch.io import registry, serving
from mmlspark_tpu_torch.models.isolation_forest import iforest_from_reference
from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
from mmlspark_tpu_torch.telemetry import exposition, lineage, quality
from mmlspark_tpu_torch.telemetry import names as tnames
from mmlspark_tpu_torch.workloads import IsolationForestScorerModel

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_N_REQUESTS = 24
_AFTER_DRAIN = 6

_CHILD = """
import json, os, signal, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.io import (RegistryClient, compile_serving_transform,
                                   list_services, start_distributed_serving)
from mmlspark_tpu_torch.io.serving import drain_on_signal
from mmlspark_tpu_torch.parallel import cluster
from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
from mmlspark_tpu_torch.telemetry import names as tnames
from mmlspark_tpu_torch.telemetry.exposition import scrape_cluster
from mmlspark_tpu_torch.telemetry.lineage import rollout_skew
from mmlspark_tpu_torch.workloads import SARServing

pid, rdv = int(sys.argv[1]), sys.argv[2]
cluster.initialize_cluster(init_method="file://" + rdv, num_processes=2,
                           process_id=pid)
assert cluster.backend_name() == "gloo"


def events(seed):
    rng = np.random.default_rng(seed)
    n = 600
    return Table({{"user": rng.integers(0, 40, n),
                   "item": rng.integers(0, 30, n),
                   "rating": rng.integers(1, 6, n).astype(np.float64),
                   "timestamp": rng.integers(0, 10**6, n).astype(
                       np.float64)}})


def fit(seed):
    return SARServing(support_threshold=2, num_recommendations=4,
                      device="cpu").fit(events(seed))


model_a = fit(0)
transform = compile_serving_transform(model_a, ["user"],
                                      output_col="recommendations")
registry, server, query, addr = start_distributed_serving(
    transform, name="sar", num_partitions=1, mode="continuous")
pids = cluster.all_gather_object(os.getpid())
if pid == 1:
    # die between batch read and commit on the NEXT request this rank's
    # worker pulls; replay must keep the request alive
    query.inject_fault(0)
cluster.barrier("fault_armed")
want = model_a.recommend_plan()(np.arange(40))
result = {{"recoveries": 0}}
if pid == 0:
    client = RegistryClient(addr, "sar")
    for i in range({n}):
        u = i % 40
        status, body = client.post(json.dumps({{"user": u}}).encode())
        assert status == 200, (status, body)
        items, ratings = json.loads(body)["recommendations"]
        assert items == want[u, 0].tolist(), (u, items)
    snap = scrape_cluster(addr, "sar", versions=True)
    result["merged_total"] = snap.merged.get(tnames.SERVING_REQUEST_TOTAL)
    result["per_worker"] = sorted(
        st["counters"].get(tnames.SERVING_REQUEST_TOTAL, 0)
        for _, st in snap.workers)
    result["skew_before"] = rollout_skew(snap.versions["current_by_worker"])
cluster.barrier("traffic_done")
result["recoveries"] = query._recoveries
if pid == 1:
    swap = transform.install_model(fit(5))
    result["swap"] = [swap["old"], swap["new"]]
cluster.barrier("swapped")
if pid == 0:
    snap = scrape_cluster(addr, "sar", versions=True)
    result["skew_after"] = rollout_skew(snap.versions["current_by_worker"])
    result["workers_per_version"] = {{
        vid: len(v["workers"]) for vid, v in snap.versions["versions"].items()}}
cluster.barrier("scraped")
if pid == 1:
    # the port's own drain: the server leaves the registry, answers what
    # is in flight, then the query stops
    drain_on_signal(servers=[server], queries=[query], exit_code=None)
cluster.barrier("handler_set")
if pid == 0:
    os.kill(pids[1], signal.SIGTERM)
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and len(
            list_services(addr, "sar")) != 1:
        time.sleep(0.05)
    result["left"] = len(list_services(addr, "sar")) == 1
    # rank 1's server is down now, not mid-drain (where it answers 503)
    cluster.barrier("drained")
    statuses = [client.post(json.dumps({{"user": 3}}).encode())[0]
                for _ in range({m})]
    result["after_drain"] = statuses
else:
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline and reliability_metrics.get(
            tnames.SERVING_SIGNAL_DRAINS) < 1:
        time.sleep(0.05)
    # the handler runs whole on this thread before the loop reads on
    result["drained"] = not server._thread.is_alive()
    result["signal_drains"] = reliability_metrics.get(
        tnames.SERVING_SIGNAL_DRAINS)
    cluster.barrier("drained")
cluster.barrier("down")
print("RESULT " + json.dumps(result), flush=True)
if pid == 0:
    query.stop(); server.stop()
if registry is not None:
    drain_on_signal(registries=[registry], exit_code=None)()
    result_thread = registry._thread.is_alive()
    assert not result_thread
cluster.barrier("stopped")
cluster.shutdown()
"""


def _run_pair(tmp_path, timeout=180):
    script = tmp_path / "child.py"
    script.write_text(textwrap.dedent(_CHILD.format(
        repo=_REPO, n=_N_REQUESTS, m=_AFTER_DRAIN)))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(p), str(tmp_path / "rdv")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in (0, 1)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=timeout)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    res = []
    for p, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"process {p} failed:\n{out[-4000:]}"
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        res.append(json.loads(lines[-1][len("RESULT "):]))
    return res


def test_distributed_serving_two_processes(tmp_path):
    r0, r1 = _run_pair(tmp_path)
    # traffic reached BOTH ranks' servers through the registry, and the
    # merged scrape counts every request the client sent
    assert r0["merged_total"] == _N_REQUESTS
    assert sum(r0["per_worker"]) == _N_REQUESTS
    assert min(r0["per_worker"]) > 0
    assert list(r0["skew_before"].values()) == [2]
    # rank 1's worker really died once and recovered via replay
    assert r1["recoveries"] >= 1
    # a swap on rank 1 alone: two versions, one worker each
    old, new = r1["swap"]
    assert r0["skew_after"] == {old: 1, new: 1}
    # rank 1 keeps the old version as its incumbent slot
    assert r0["workers_per_version"] == {old: 2, new: 1}
    # SIGTERM: rank 1 drained, left the registry, and the client fails
    # over to rank 0 and answers
    assert r1["drained"] and r1["signal_drains"] == 1
    assert r0["left"]
    assert r0["after_drain"] == [200] * _AFTER_DRAIN


# ----------------------------------------------- the merges on one host
def _exports():
    """Three workers' /versions exports: one mid-rollout."""
    def metrics(n, ms):
        return {"counters": {tnames.SERVING_REQUEST_TOTAL: n},
                "timings": {}, "gauges": {"g": float(n)},
                "hists": {}}
    return [
        ("http://a:1", {"current": "v1", "versions": {
            "v1": {"version": "v1", "role": "incumbent",
                   "metrics": metrics(5, 1.0)}}}),
        ("http://b:2", {"current": "v2", "versions": {
            "v1": {"version": "v1", "role": "incumbent",
                   "metrics": metrics(3, 2.0)},
            "v2": {"version": "v2", "role": "candidate",
                   "metrics": metrics(7, 3.0)}}}),
        ("http://c:3", {"current": None, "versions": {}}),
        ("http://d:4", "torn export"),
    ]


def test_merge_version_exports_and_skew_equal_reference():
    exports = _exports()
    got = lineage.merge_version_exports(exports)
    want = ref_lineage.merge_version_exports(exports)
    assert got == want
    assert got["versions"]["v1"]["role"] == "incumbent"
    assert got["versions"]["v2"]["role"] == "candidate"
    assert got["versions"]["v1"]["workers"] == ["http://a:1", "http://b:2"]
    skew = lineage.rollout_skew(got["current_by_worker"])
    assert skew == ref_lineage.rollout_skew(want["current_by_worker"])
    assert skew == {"v1": 1, "v2": 1}


@pytest.fixture
def fresh_state():
    for m in (reliability_metrics, ref_metrics):
        m.reset()
    quality.reset_monitor()
    ref_quality.reset_monitor()
    lineage.reset_version_registry()
    ref_lineage.reset_version_registry()
    yield
    for m in (reliability_metrics, ref_metrics):
        m.reset()
    quality.reset_monitor()
    ref_quality.reset_monitor()
    lineage.reset_version_registry()
    ref_lineage.reset_version_registry()


def _ids_out(obj, ids):
    """`obj` with every version id in `ids` replaced by its position."""
    text = json.dumps(obj, sort_keys=True, default=str)
    for i, vid in enumerate(ids):
        text = text.replace(vid, f"<version {i}>")
    return json.loads(text)


def _fleet(pkg_registry, pkg_serving, model, x, n_servers=2):
    reg = pkg_registry.ServiceRegistry().start()
    servers, queries = [], []
    for _ in range(n_servers):
        srv, q = pkg_serving.serve_pipeline(model, ["features"],
                                            output_col="outlierScore",
                                            mode="continuous")
        host, port = srv._httpd.server_address[:2]
        pkg_registry.report_server_to_registry(
            reg.address, "iforest", host, port,
            version=q.transform_fn.version)
        servers.append(srv)
        queries.append(q)
    client = pkg_registry.RegistryClient(reg.address, "iforest")
    for i in range(10):
        body = json.dumps({"features": [float(v) for v in x[i % 5]]})
        status, _ = client.post(body.encode())
        assert status == 200
    return reg, servers, queries, queries[0].transform_fn.version


def test_scrape_cluster_versions_equal_reference(fresh_state):
    """Both packages serve the same isolation forest behind their own
    registry on two servers; the fleet scrapes agree on the merged
    request counts and, up to the version ids, on the merged
    `/versions`."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 4))
    ref_model = RefScorer(num_estimators=8, max_samples=32,
                          seed=1).fit(RefTable({"features": x}))
    port_model = iforest_from_reference(
        ref_model, cls=IsolationForestScorerModel, device="cpu")
    port_model._n_features = ref_model._n_features
    fleets = []
    try:
        fleets.append(_fleet(ref_registry, ref_serving, ref_model, x))
        ref_snap = ref_exposition.scrape_cluster(
            fleets[0][0].address, "iforest", versions=True)
        fleets.append(_fleet(registry, serving, port_model, x))
        snap = exposition.scrape_cluster(fleets[1][0].address, "iforest",
                                         versions=True)
    finally:
        for reg, servers, queries, _ in fleets:
            for q in queries:
                q.stop()
            for s in servers:
                s.stop()
            reg.stop()
    key = tnames.SERVING_REQUEST_TOTAL
    # one process: every worker reports the process-wide registry, so
    # the merge counts each request once per worker, in both packages
    assert snap.merged[key] == ref_snap.merged[key] == 20
    assert snap.merged["telemetry.scrape.workers"] == 2
    assert snap.slo is None and ref_snap.slo is None
    vid, ref_vid = fleets[1][3], fleets[0][3]
    assert vid != ref_vid
    want = _ids_out(ref_snap.versions, [ref_vid])
    got = _ids_out(snap.versions, [vid])
    addrs = [[f"http://{h}:{p}" for h, p in (s._httpd.server_address[:2]
                                            for s in f[1])] for f in fleets]
    want = _ids_out(want, addrs[0])
    got = _ids_out(got, addrs[1])
    for merged in (want, got):
        for entry in merged["versions"].values():
            # the digests are ids too; lineage and install times differ
            for field in ("content_digest", "fingerprint", "lineage",
                          "installed_at"):
                entry.pop(field, None)
            # latencies are measurements, not merge results
            entry["metrics"] = {
                k: entry["metrics"][k] for k in ("counters",)}
            entry["split"] = {k: v for k, v in entry["split"].items()
                              if not k.endswith("_ms")}
            # sorted by address, which orders the two fleets' ports apart
            entry["workers"] = sorted(entry["workers"])
    assert got == want
    assert lineage.rollout_skew(snap.versions["current_by_worker"]) == \
        {vid: 2}


def test_left_out_options_name_their_item(fresh_state):
    """The SLO merge of the fleet scrape waits for item 27."""
    with pytest.raises(NotImplementedError, match="item 27"):
        exposition.scrape_cluster("http://127.0.0.1:9", slo=True)


def test_scrape_cluster_skips_dead_workers(fresh_state):
    reg = registry.ServiceRegistry().start()
    try:
        registry.report_server_to_registry(reg.address, "gone",
                                           "127.0.0.1", 9)
        snap = exposition.scrape_cluster(reg.address, "gone")
        assert snap.workers == [] and \
            snap.merged["telemetry.scrape.workers"] == 0
        with pytest.raises(RuntimeError, match="scrape of"):
            exposition.scrape_cluster(reg.address, "gone",
                                      skip_unreachable=False)
        with urllib.request.urlopen(reg.address + "/metrics.json",
                                    timeout=10) as r:
            assert "counters" in json.loads(r.read())
    finally:
        reg.stop()
