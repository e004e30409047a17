"""`parallel.cluster` of the port: the cases of tests/test_cluster.py on
CPU positions, the row arithmetic against the JAX reference's, and a
real two-process gloo job (`file://` rendezvous in `tmp_path`) running
the primitives as tests/test_multiprocess.py:96-133 does: a 103-row
ragged sum over the data axis, the leader's broadcast, a barrier, and
spans that partition the rows exactly."""
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from mmlspark_tpu.parallel import cluster as ref_cluster
from mmlspark_tpu.parallel import data_mesh as ref_data_mesh
from mmlspark_tpu_torch.parallel import (barrier, broadcast_from_leader,
                                         cluster, data_mesh, device_count,
                                         global_array, initialize_cluster,
                                         padded_process_rows,
                                         process_row_range)
from mmlspark_tpu_torch.reliability import (FaultInjector, InjectedFault,
                                            MetricsRegistry, Preempted,
                                            RetryPolicy, TrainingSupervisor,
                                            reliability_metrics)
from mmlspark_tpu_torch.reliability import names as tnames

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_initialize_single_process_is_noop():
    info = initialize_cluster()
    assert info.process_id == 0 and info.process_count == 1
    assert info.global_device_count == info.local_device_count >= 1
    assert cluster.backend_name() is None
    assert device_count() == torch.cuda.device_count()


def test_backend_is_gloo_without_a_card_per_rank():
    """NCCL refuses two ranks on one card: gloo unless every rank has its
    own card (here, no card at all)."""
    want = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    assert cluster.choose_backend(2, local_processes=2) == want
    assert cluster.choose_backend(4, local_processes=4) in ("gloo", "nccl")
    if not torch.cuda.is_available():
        assert cluster.choose_backend(1) == "gloo"


def test_process_row_range_partitions_exactly():
    n = 103
    spans = [process_row_range(n, pid, 8) for pid in range(8)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    sizes = []
    for (lo, hi), (lo2, _) in zip(spans, spans[1:]):
        assert hi == lo2
        sizes.append(hi - lo)
    sizes.append(spans[-1][1] - spans[-1][0])
    assert max(sizes) - min(sizes) <= 1
    for n in (0, 1, 7, 103, 1000):
        for procs in (1, 2, 3, 8):
            assert [process_row_range(n, p, procs) for p in range(procs)] \
                == [ref_cluster.process_row_range(n, p, procs)
                    for p in range(procs)]


def test_global_array_row_sharded():
    mesh = data_mesh(devices=["cpu"] * 8)
    arr = np.arange(64, dtype=np.float32).reshape(16, 4)
    parts = global_array(mesh, arr)
    assert len(parts) == 8 and all(p.shape == (2, 4) for p in parts)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), arr)


def test_padded_process_rows_even_blocks():
    mesh = data_mesh(devices=["cpu"] * 8)
    spans = [padded_process_rows(103, mesh, pid, 2) for pid in range(2)]
    blocks = {b for _, _, b in spans}
    assert len(blocks) == 1
    block = blocks.pop()
    assert block % 4 == 0 and 2 * block >= 103
    assert spans[0][0] == 0 and spans[1][1] == 103
    assert spans[0][1] == min(block, 103) == spans[1][0]
    ref_mesh = ref_data_mesh(8)
    for n, procs in ((103, 2), (1000, 4), (5, 8)):
        assert [padded_process_rows(n, mesh, p, procs)
                for p in range(procs)] == \
            [ref_cluster.padded_process_rows(n, ref_mesh, p, procs)
             for p in range(procs)]


def test_barrier_and_broadcast_single_process():
    barrier("test")
    out = broadcast_from_leader(np.array([1, 2, 3]))
    np.testing.assert_array_equal(out, [1, 2, 3])
    assert broadcast_from_leader({"a": 1}) == {"a": 1}


def test_failed_rendezvous_raises_and_counts_retries(tmp_path):
    """A rendezvous whose peer never comes raises after its timeout (never
    N disconnected jobs), each retry counted."""
    reliability_metrics.reset(prefix="cluster.")
    policy = RetryPolicy(max_attempts=2, backoff=0.0, max_backoff=0.0)
    with pytest.raises((RuntimeError, TimeoutError)):
        initialize_cluster(init_method=f"file://{tmp_path / 'rdv'}",
                           num_processes=2, process_id=0,
                           retry_policy=policy, timeout_s=1.0)
    assert not torch.distributed.is_initialized()
    assert reliability_metrics.get(tnames.CLUSTER_RENDEZVOUS_RETRIES) >= 1
    with pytest.raises(ValueError, match="num_processes and process_id"):
        initialize_cluster(num_processes=2)


# -- heartbeat/rejoin ----------------------------------------------------------

def test_heartbeat_rejoin_detection(tmp_path):
    from mmlspark_tpu_torch.parallel.cluster import Heartbeat
    reliability_metrics.reset(prefix="cluster.")
    hb = Heartbeat(str(tmp_path), process_id=0)
    assert not hb.rejoining
    hb.beat(3)
    hb.beat(7)
    hb2 = Heartbeat(str(tmp_path), process_id=0)
    assert hb2.rejoining and hb2.resume_epoch == 7
    assert reliability_metrics.gauge(tnames.CLUSTER_RESUME_EPOCH) == 7
    assert reliability_metrics.get(tnames.CLUSTER_REJOINS) == 1
    assert not Heartbeat(str(tmp_path), process_id=1).rejoining
    assert Heartbeat(str(tmp_path), process_id=1).read(0)["epoch"] == 7
    hb2.clear()
    assert not Heartbeat(str(tmp_path), process_id=0).rejoining
    inj = FaultInjector(seed=1, rules=[
        {"site": "cluster.heartbeat", "kind": "error", "at": [0]}])
    hb3 = Heartbeat(str(tmp_path), process_id=2, faults=inj)
    with pytest.raises(InjectedFault):
        hb3.beat(1)
    assert ("cluster.heartbeat", 0, "error") in inj.schedule()


def test_heartbeat_rides_supervisor_epochs(tmp_path):
    """TrainingSupervisor(heartbeat=) beats at every checkpoint mark and
    clears on a clean finish; a preempted run leaves its last epoch for
    the restarted process to detect."""
    from mmlspark_tpu_torch.parallel.cluster import Heartbeat
    state = {"x": 0.0}
    hb = Heartbeat(str(tmp_path / "hb"), process_id=0)

    def mk(d, hb):
        return TrainingSupervisor(
            d, lambda: {"x": state["x"]},
            lambda p: state.update(x=float(p["x"])),
            checkpoint_every=2, heartbeat=hb, metrics=MetricsRegistry())

    sup = mk(str(tmp_path / "ck"), hb)

    def step(k):
        state["x"] += 1
        if k == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return state["x"]

    with pytest.raises(Preempted):
        sup.run(step, 100)
    sup.close()
    hb2 = Heartbeat(str(tmp_path / "hb"), process_id=0)
    assert hb2.rejoining and hb2.resume_epoch == 5
    sup2 = mk(str(tmp_path / "ck2"), hb2)
    sup2.run(lambda k: k, 4)
    sup2.close()
    assert not Heartbeat(str(tmp_path / "hb"), process_id=0).rejoining


# -- two real processes ----------------------------------------------------------

_PRIMITIVES = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from mmlspark_tpu_torch.parallel import cluster, data_mesh, shard_rows
from mmlspark_tpu_torch.models.gbdt.trainer import _sum_positions

pid, rdv = int(sys.argv[1]), sys.argv[2]
info = cluster.initialize_cluster(init_method="file://" + rdv,
                                  num_processes=2, process_id=pid)
assert info.process_count == 2 and info.process_id == pid, info
n = 103
mesh = data_mesh(devices=["cpu"] * 2)      # 2 positions a process: 4
lo, hi, block = cluster.padded_process_rows(n, mesh)
rows = np.arange(n, dtype=np.float32)
parts, _ = shard_rows(mesh, rows)          # this process's 2 positions
local = [p.sum() for p in parts]
total = float(_sum_positions(local, parts[0].device, mesh.exchange))
gathered = mesh.exchange.gather_rows(torch.from_numpy(rows[lo:hi]))
lead = cluster.broadcast_from_leader(np.array([pid * 10 + 5]))
cluster.barrier("primitives")
lo2, hi2 = cluster.process_row_range(n)
print("RESULT " + json.dumps({{
    "total": total, "lead": int(lead[0]), "block": block,
    "span": [lo, hi], "plain_span": [lo2, hi2],
    "shape": mesh.shape["data"], "local": mesh.local_positions,
    "offset": mesh.position_offset,
    "gathered": gathered.tolist(),
    "exchanges": mesh.exchange.stats()["calls"]}}), flush=True)
cluster.shutdown()
"""


def test_cluster_primitives_two_processes(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(_PRIMITIVES.format(repo=_REPO)))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(p), str(tmp_path / "rdv")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in (0, 1)]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=120)[0])
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
    r0, r1 = res
    expect = 103 * 102 / 2
    assert r0["total"] == expect and r1["total"] == expect
    assert r0["lead"] == 5 and r1["lead"] == 5
    assert r0["block"] == r1["block"]
    assert r0["span"][0] == 0 and r1["span"][1] == 103
    assert r0["span"][1] == min(r0["block"], 103) == r1["span"][0]
    assert r0["plain_span"][0] == 0 and r1["plain_span"][1] == 103
    assert r0["plain_span"][1] == r1["plain_span"][0]
    assert (r0["shape"], r0["local"], r0["offset"], r1["offset"]) == \
        (4, 2, 0, 2)
    # the rows of both processes, in process order, on both
    assert r0["gathered"] == r1["gathered"] == list(range(103))
    assert r0["exchanges"] == r1["exchanges"] == 3
