"""Elastic multi-process training of the port (`reliability.elastic`,
`parallel.cluster.Heartbeat`, `telemetry.goodput.StragglerDetector`,
`data.ChunkPlanner`): the in-process cases of tests/test_elastic.py and
tests/test_goodput.py's straggler cases, on CPU positions.

Liveness runs on an injectable observer clock, so the tests advance time
instead of sleeping. The acceptance case runs 3 hosts over 6 CPU
positions: a host dies mid-staging, the survivors detect it by lease,
fence the zombie out, shrink the chunk plan and mesh to 4 positions,
re-stage its chunks and resume from the committed manifest, and the
resumed model equals a fresh fit of the surviving hosts from the
committed state bit for bit (the reference's compile records are ROADMAP
Queue 1 item 24). One case SIGKILLs a real process and its lease runs
out. The port's tracer and run ledger are item 23; these tests record
the events with stand-ins of the same interface."""
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu.telemetry import names as ref_names
from mmlspark_tpu_torch.data import ChunkPlanner, ChunkStager, OocoreOptions
from mmlspark_tpu_torch.models.gbdt import Booster, BoostParams
from mmlspark_tpu_torch.models.gbdt.distributed import fit_booster_distributed
from mmlspark_tpu_torch.ops import binning
from mmlspark_tpu_torch.parallel import data_mesh
from mmlspark_tpu_torch.parallel.cluster import (FencedOut, Heartbeat,
                                                 read_fences)
from mmlspark_tpu_torch.reliability import (ElasticPlan, FleetCheckpoint,
                                            HostLeases, leader)
from mmlspark_tpu_torch.reliability import names as tnames
from mmlspark_tpu_torch.reliability.faults import (FaultInjector,
                                                   InjectedCrash)
from mmlspark_tpu_torch.reliability.metrics import MetricsRegistry
from mmlspark_tpu_torch.telemetry.goodput import StragglerDetector

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Clock:
    """Injectable observer clock: tests advance it explicitly."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += float(s)


class _Tracer:
    """The tracer interface the elastic path calls (`event`)."""

    def __init__(self):
        self.events = []

    def event(self, name, **attrs):
        self.events.append((name, attrs))

    def finished(self, name):
        return [a for n, a in self.events if n == name]


class _Ledger:
    """The run-ledger interface (`append_event`), one record a line."""

    def __init__(self):
        self.rows = []

    def append_event(self, event, **attrs):
        self.rows.append(dict(attrs, event=event))

    def records(self):
        return list(self.rows)


def _dataset(n=1536, f=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=f)
    y = (x @ w + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return x, y


def _same_booster(a, b):
    ba, base_a, _ = a
    bb, base_b, _ = b
    assert base_a == base_b
    for field in ba._fields:
        va, vb = getattr(ba, field), getattr(bb, field)
        assert np.array_equal(np.asarray(va), np.asarray(vb)), field


def _params(**kw):
    base = dict(objective="binary", num_iterations=6, num_leaves=15,
                max_depth=4, max_bin=31, min_data_in_leaf=5)
    base.update(kw)
    return BoostParams(**base)


def test_metric_and_event_names_are_the_reference_s():
    for name in ("CLUSTER_REJOINS", "CLUSTER_HEARTBEAT_ERRORS",
                 "CLUSTER_RENDEZVOUS_RETRIES", "CLUSTER_FENCE_REJECTS",
                 "CLUSTER_HEARTBEAT_TMP_SWEPT", "CLUSTER_RESUME_EPOCH",
                 "CLUSTER_HOSTS_LIVE", "CLUSTER_HOSTS_DEAD",
                 "TRAIN_STRAGGLERS", "ELASTIC_MANIFEST_COMMITS",
                 "ELASTIC_MANIFEST_REJECTED", "ELASTIC_SHRINKS",
                 "ELASTIC_RESUMES", "TRAIN_STRAGGLER_EVENT",
                 "TRAIN_CHUNK_REASSIGN_EVENT", "TRAIN_HOST_DEAD_EVENT",
                 "ELASTIC_PLAN_EVENT", "ELASTIC_RESUME_EVENT"):
        assert getattr(tnames, name) == getattr(ref_names, name), name


# ------------------------------------------------------------------ leases
def test_lease_expiry_declares_dead_once_with_gauges(tmp_path):
    hb0 = Heartbeat(str(tmp_path), process_id=0)
    hb1 = Heartbeat(str(tmp_path), process_id=1)
    hb0.beat(1)
    hb1.beat(1)
    clock = _Clock()
    reg = MetricsRegistry()
    tracer, ledger = _Tracer(), _Ledger()
    leases = HostLeases(hb0, lease_timeout_s=5.0, clock=clock,
                        faults=None, metrics=reg, tracer=tracer,
                        ledger=ledger)
    assert leases.check() == []
    clock.advance(3.0)
    hb1.beat(2)
    assert leases.check() == []
    clock.advance(4.0)
    hb0.beat(2)
    assert leases.check() == []
    clock.advance(2.0)
    hb0.beat(3)
    assert leases.check() == [1]
    assert leases.check() == []
    assert leases.dead == [1] and leases.live == [0]
    assert reg.peek_gauge(tnames.CLUSTER_HOSTS_LIVE) == 1.0
    assert reg.peek_gauge(tnames.CLUSTER_HOSTS_DEAD) == 1.0
    deaths = tracer.finished(tnames.TRAIN_HOST_DEAD_EVENT)
    assert len(deaths) == 1 and deaths[0]["host"] == 1
    rows = [r for r in ledger.records()
            if r.get("event") == tnames.TRAIN_HOST_DEAD_EVENT]
    assert len(rows) == 1 and rows[0]["host"] == 1


def test_zombie_beat_fenced_out_and_fresh_incarnation_rejoins(tmp_path):
    reg = MetricsRegistry()
    hb0 = Heartbeat(str(tmp_path), process_id=0)
    hb1 = Heartbeat(str(tmp_path), process_id=1, metrics=reg)
    hb0.beat(1)
    hb1.beat(1)
    clock = _Clock()
    leases = HostLeases(hb0, lease_timeout_s=5.0, clock=clock, faults=None,
                        metrics=MetricsRegistry())
    leases.check()
    clock.advance(6.0)
    hb0.beat(2)
    assert leases.check() == [1]
    assert read_fences(str(tmp_path)) == {1: 1}
    before = hb0.read(1)
    with pytest.raises(FencedOut):
        hb1.beat(7)
    assert reg.get(tnames.CLUSTER_FENCE_REJECTS) == 1
    assert hb0.read(1) == before
    torn = dict(before, epoch=9, fence=0)
    with open(hb1.path, "w") as f:
        json.dump(torn, f)
    assert all(int(r["process_id"]) != 1 for r in hb0.read_all())
    hb1b = Heartbeat(str(tmp_path), process_id=1)
    assert hb1b.fence_epoch == 1
    hb1b.beat(8)
    assert any(int(r["process_id"]) == 1 and r["epoch"] == 8
               for r in hb0.read_all())


def test_read_all_age_annotation_and_stale_filter(tmp_path):
    hb0 = Heartbeat(str(tmp_path), process_id=0)
    hb1 = Heartbeat(str(tmp_path), process_id=1)
    hb0.beat(1)
    hb1.beat(1)
    rows = hb0.read_all()
    assert len(rows) == 2
    assert all(0.0 <= r["age_s"] < 60.0 for r in rows)
    old = time.time() - 120.0
    os.utime(hb1.path, (old, old))
    kept = hb0.read_all(max_age_s=60.0)
    assert [int(r["process_id"]) for r in kept] == [0]
    aged = {int(r["process_id"]): r["age_s"] for r in hb0.read_all()}
    assert len(aged) == 2 and aged[1] > 100.0


def test_straggler_detector_flags_deviating_host(tmp_path):
    reg = MetricsRegistry()
    tracer = _Tracer()
    hb0 = Heartbeat(str(tmp_path), process_id=0)
    hb1 = Heartbeat(str(tmp_path), process_id=1)
    hb0.beat(5, stats={"step_p50_ms": 2.0, "steps": 8, "goodput": 1.0})
    hb1.beat(5, stats={"step_p50_ms": 200.0, "steps": 8, "goodput": 0.1})
    det = StragglerDetector(hb0, threshold=1.5, registry=reg, tracer=tracer)
    flagged = det.check()
    assert [s["process_id"] for s in flagged] == [1]
    assert reg.gauge(tnames.TRAIN_STRAGGLERS) == 1
    events = tracer.finished(tnames.TRAIN_STRAGGLER_EVENT)
    assert len(events) == 1 and events[0]["host"] == 1
    det.check()
    assert len(tracer.finished(tnames.TRAIN_STRAGGLER_EVENT)) == 1
    hb1.beat(6, stats={"step_p50_ms": 2.2, "steps": 12, "goodput": 0.99})
    assert det.check() == []
    assert reg.gauge(tnames.TRAIN_STRAGGLERS) == 0


def test_straggler_detector_skips_frozen_stats_regression(tmp_path):
    hbs = [Heartbeat(str(tmp_path), process_id=i) for i in range(3)]
    for i, hb in enumerate(hbs):
        p50 = 9.0 if i == 2 else 2.0
        hb.beat(1, stats={"step_p50_ms": p50, "steps": 8, "goodput": 1.0})
    old = time.time() - 120.0
    os.utime(hbs[2].path, (old, old))
    det = StragglerDetector(hbs[0], threshold=1.5, max_age_s=60.0,
                            registry=MetricsRegistry(),
                            profile_on_flag=False)
    assert det.check() == []
    legacy = StragglerDetector(hbs[0], threshold=1.5, max_age_s=None,
                               registry=MetricsRegistry(),
                               profile_on_flag=False)
    assert [f["process_id"] for f in legacy.check()] == [2]


def test_supervisor_straggler_threshold_drives_the_planner(tmp_path):
    """`straggler_threshold` builds the detector from the heartbeat; a
    flagged host's pending chunks drain on the beat."""
    from mmlspark_tpu_torch.reliability import TrainingSupervisor
    hb0 = Heartbeat(str(tmp_path / "hb"), process_id=0)
    for pid, p50 in ((1, 100.0), (2, 2.5)):
        Heartbeat(str(tmp_path / "hb"), process_id=pid).beat(
            1, stats={"step_p50_ms": p50, "steps": 8, "goodput": 1.0})
    planner = ChunkPlanner(6, hosts=[0, 1])
    state = {"x": 0.0}
    sup = TrainingSupervisor(
        str(tmp_path / "ck"), lambda: {"x": state["x"]},
        lambda p: state.update(x=float(p["x"])), checkpoint_every=1,
        heartbeat=hb0, straggler_threshold=3.0, chunk_planner=planner,
        metrics=MetricsRegistry())
    assert sup.straggler.threshold == 3.0

    def step(k):
        time.sleep(0.002)
        return k
    sup.run(step, 6)
    sup.close()
    assert planner.pending(1) == [] and planner.hosts == [0, 1]


def test_heartbeat_init_sweeps_leaked_beat_tmps(tmp_path):
    own_tmp = tmp_path / "heartbeat_0.json.12345.tmp"
    stale_tmp = tmp_path / "heartbeat_1.json.777.tmp"
    fresh_tmp = tmp_path / "heartbeat_2.json.888.tmp"
    for p in (own_tmp, stale_tmp, fresh_tmp):
        p.write_text("{}")
    old = time.time() - 300.0
    os.utime(stale_tmp, (old, old))
    reg = MetricsRegistry()
    Heartbeat(str(tmp_path), process_id=0, metrics=reg)
    assert not own_tmp.exists()
    assert not stale_tmp.exists()
    assert fresh_tmp.exists()
    assert reg.get(tnames.CLUSTER_HEARTBEAT_TMP_SWEPT) == 2


# ----------------------------------------------------------- planner shrink
def test_planner_remove_hosts_drains_and_shrinks_rotation():
    tracer = _Tracer()
    planner = ChunkPlanner(9, hosts=[0, 1, 2], faults=None, tracer=tracer)
    done = planner.assigned(2)[0]
    planner.mark_done(done)
    moved = planner.remove_hosts([2])
    assert moved and all(frm == 2 for frm, _ in moved.values())
    assert done not in moved
    assert planner.hosts == [0, 1]
    assert planner.pending(2) == []
    assert tracer.finished(tnames.TRAIN_CHUNK_REASSIGN_EVENT)[0][
        "from_host"] == 2
    later = planner.reassign([1])
    assert later and all(to == 0 for _, to in later.values())
    assert planner.remove_hosts([5]) == {}
    assert planner.remove_hosts([0, 1]) == {}
    assert planner.hosts == [0, 1]


# ------------------------------------------------------- fleet checkpoints
def _shard_payload(step, pid=0):
    return {"w": np.arange(4, dtype=np.float32) + step, "step": int(step),
            "host": int(pid)}


def test_fleet_two_phase_commit_leader_and_reelection(tmp_path):
    d = str(tmp_path)
    fleets = {pid: FleetCheckpoint(d, pid, faults=None) for pid in (0, 1, 2)}
    assert leader([0, 1, 2]) == 0 and leader([1, 2]) == 1
    with pytest.raises(ValueError):
        leader([])
    fleets[0].save_shard(2, _shard_payload(2, 0))
    assert fleets[0].commit(2, [0, 1, 2]) is False
    fleets[1].save_shard(2, _shard_payload(2, 1))
    fleets[2].save_shard(2, _shard_payload(2, 2))
    assert fleets[1].commit(2, [0, 1, 2]) is False
    assert fleets[0].commit(2, [0, 1, 2],
                            extra={"oocore_cursor": 7}) is True
    step, manifest = fleets[2].latest_committed()
    assert step == 2
    assert sorted(manifest["hosts"]) == ["0", "1", "2"]
    assert manifest["leader"] == 0 and manifest["oocore_cursor"] == 7
    rstep, rman, payload = fleets[2].restore()
    assert rstep == 2 and rman == manifest
    assert np.array_equal(payload["w"], _shard_payload(2, 2)["w"])
    assert payload["host"] == 2
    for pid in (1, 2):
        fleets[pid].save_shard(4, _shard_payload(4, pid))
    assert fleets[2].commit(4, [1, 2]) is False
    assert fleets[1].commit(4, [1, 2]) is True
    step, manifest = fleets[1].latest_committed()
    assert step == 4 and sorted(manifest["hosts"]) == ["1", "2"]
    assert manifest["leader"] == 1


def test_fleet_restore_refuses_torn_and_partial_manifests(tmp_path):
    d = str(tmp_path)
    reg = MetricsRegistry()
    fleets = {pid: FleetCheckpoint(d, pid, faults=None, metrics=reg)
              for pid in (0, 1)}
    for pid in (0, 1):
        fleets[pid].save_shard(2, _shard_payload(2, pid))
    assert fleets[0].commit(2, [0, 1]) is True
    with open(os.path.join(d, "manifest_step_6.json"), "w") as f:
        f.write('{"step": 6, "hosts": {"0"')
    fleets[0].save_shard(4, _shard_payload(4, 0))
    with open(os.path.join(d, "manifest_step_4.json"), "w") as f:
        json.dump({"step": 4, "leader": 0, "hosts": {
            "0": fleets[0]._member_digests(0, 4), "1": {"meta": "ab"}}}, f)
    with open(os.path.join(d, "manifest_step_3.json"), "w") as f:
        json.dump({"step": 3, "leader": 0,
                   "hosts": {"0": {"meta": "00"}}}, f)
    step, manifest = fleets[1].latest_committed()
    assert step == 2 and sorted(manifest["hosts"]) == ["0", "1"]
    assert reg.get(tnames.ELASTIC_MANIFEST_REJECTED) == 3
    assert fleets[1].restore()[0] == 2


# ------------------------------------------------------------------- chaos
def test_chaos_lease_expire_false_positive_costs_one_beat(tmp_path):
    hb0 = Heartbeat(str(tmp_path), process_id=0)
    hb1 = Heartbeat(str(tmp_path), process_id=1)
    hb0.beat(1)
    hb1.beat(1)
    inj = FaultInjector(seed=5, rules=[
        {"site": "cluster.lease.expire", "kind": "expire", "at": [1]}])
    ledger = _Ledger()
    leases = HostLeases(hb0, lease_timeout_s=1e9, clock=_Clock(),
                        faults=inj, metrics=MetricsRegistry(), ledger=ledger)
    assert leases.check() == [1]
    assert [r["host"] for r in ledger.records()
            if r.get("event") == tnames.TRAIN_HOST_DEAD_EVENT] == [1]
    with pytest.raises(FencedOut):
        hb1.beat(2)
    hb1.adopt_fence()
    hb1.beat(3)
    assert hb0.read(1)["epoch"] == 3
    inj2 = FaultInjector(seed=5, rules=[
        {"site": "cluster.lease.expire", "kind": "error", "at": [0]}])
    leases2 = HostLeases(hb0, lease_timeout_s=1e9, clock=_Clock(),
                         faults=inj2, metrics=MetricsRegistry())
    assert leases2.check() == []
    assert leases2.dead == []


def test_chaos_commit_crash_next_leader_recommits(tmp_path):
    d = str(tmp_path)
    inj = FaultInjector(seed=3, rules=[
        {"site": "elastic.commit", "kind": "crash", "at": [0]}])
    fleets = {0: FleetCheckpoint(d, 0, faults=inj),
              1: FleetCheckpoint(d, 1, faults=None),
              2: FleetCheckpoint(d, 2, faults=None)}
    for pid in (0, 1, 2):
        fleets[pid].save_shard(2, _shard_payload(2, pid))
    with pytest.raises(InjectedCrash):
        fleets[0].commit(2, [0, 1, 2])
    assert fleets[1].latest_committed() is None
    assert fleets[1].restore() is None
    assert any(n.endswith(".tmp") for n in os.listdir(d))
    assert fleets[1].commit(2, [1, 2]) is True
    step, manifest = fleets[2].latest_committed()
    assert step == 2 and sorted(manifest["hosts"]) == ["1", "2"]


# ------------------------------------------------------- supervisor wiring
def test_supervisor_beat_drives_lease_check_and_shrink(tmp_path):
    hb0 = Heartbeat(str(tmp_path), process_id=0)
    hb1 = Heartbeat(str(tmp_path), process_id=1)
    hb1.beat(1)
    clock = _Clock()
    leases = HostLeases(hb0, lease_timeout_s=5.0, clock=clock, faults=None,
                        metrics=MetricsRegistry())
    shrinks = []

    class Elastic:
        def shrink(self, dead):
            shrinks.append(list(dead))
            raise RuntimeError("actuator broke")

    class Clock:
        def beat_stats(self):
            return {"step_p50_ms": 2.0, "steps": 8, "goodput": 1.0}

    from mmlspark_tpu_torch.reliability import supervisor as sup
    s = sup.TrainingSupervisor.__new__(sup.TrainingSupervisor)
    s.heartbeat = hb0
    s.clock = Clock()
    s.metrics = MetricsRegistry()
    s.straggler = None
    s.chunk_planner = None
    s.host_leases = leases
    s.elastic = Elastic()
    s._beat(1)
    assert shrinks == []
    clock.advance(6.0)
    s._beat(2)
    assert shrinks == [[1]]
    hb1b = Heartbeat(str(tmp_path), process_id=1)
    hb1b.beat(2)
    clock2 = _Clock()
    s.host_leases = HostLeases(hb0, lease_timeout_s=5.0, clock=clock2,
                               faults=None, metrics=MetricsRegistry())
    s.elastic = None
    s.chunk_planner = ChunkPlanner(6, hosts=[0, 1], faults=None)
    s._beat(3)
    clock2.advance(6.0)
    s._beat(4)
    assert s.chunk_planner.hosts == [0]
    assert s.chunk_planner.pending(1) == []


# ----------------------------------------------------------- the acceptance
def test_sigkill_one_host_shrink_resume_bit_identical(tmp_path):
    """Three hosts fit out of core over 6 CPU positions, fleet-committing
    at iteration 3; host 2 dies mid-staging; the survivors detect it by
    lease expiry, fence the zombie out, shrink the plan and mesh,
    re-stage its chunks from the shared spill cache and resume from the
    committed manifest: the resumed model equals a fresh surviving-host
    fit from the committed state bit for bit, and the ledger orders
    `train.host.dead < elastic.plan < elastic.resume`."""
    x, y = _dataset()
    p_total = _params(num_iterations=6)
    mapper = binning.fit_bins(x, max_bin=p_total.max_bin)
    x_path = str(tmp_path / "x.npy")
    np.save(x_path, x)
    cache = str(tmp_path / "bins.npy")
    opts = OocoreOptions(max_resident_bytes=x.nbytes // 8, cache_path=cache)
    n_chunks = len(ChunkStager(x_path, mapper, opts, only=set()).source)
    assert n_chunks >= 6

    tracer, ledger = _Tracer(), _Ledger()
    planner = ChunkPlanner(n_chunks, hosts=[0, 1, 2], faults=None,
                           tracer=tracer, ledger=ledger)
    hb = {i: Heartbeat(str(tmp_path / "hb"), process_id=i)
          for i in range(3)}
    fleets = {i: FleetCheckpoint(str(tmp_path / "ck"), i, faults=None)
              for i in range(3)}

    def stage_host(h):
        todo = set(planner.pending(h))
        if todo:
            ChunkStager(x_path, mapper, opts, only=todo).stage(
                device="cpu")
            for i in todo:
                planner.mark_done(i)

    stage_host(0)
    stage_host(1)
    first2 = planner.pending(2)[0]
    ChunkStager(x_path, mapper, opts, only={first2}).stage(device="cpu")
    planner.mark_done(first2)
    staged_before_death = n_chunks - len(planner.pending(2))
    committed = {}

    def ck_fn(it, booster, fit_base, final=False, margin=None,
              rng_key=None):
        if it != 3:
            return
        payload = {"booster": booster.save_model_string(),
                   "iteration": int(it), "base": float(fit_base),
                   "margin": np.asarray(margin, np.float32)}
        committed.update(payload)
        for pid in (0, 1, 2):
            fleets[pid].save_shard(it, payload)
        assert fleets[0].commit(
            it, [0, 1, 2],
            extra={"oocore_cursor": staged_before_death}) is True

    fit_booster_distributed(x, y, p_total,
                            mesh=data_mesh(devices=["cpu"] * 6),
                            checkpoint_fn=ck_fn, checkpoint_interval=3)
    assert committed and fleets[1].latest_committed()[0] == 3

    clock = _Clock()
    for i in range(3):
        hb[i].beat(1)
    leases = HostLeases(hb[0], lease_timeout_s=10.0, clock=clock,
                        faults=None, metrics=MetricsRegistry(),
                        tracer=tracer, ledger=ledger)
    assert leases.check() == []
    clock.advance(11.0)
    hb[0].beat(2)
    hb[1].beat(2)
    assert leases.check() == [2]
    reg2 = MetricsRegistry()
    hb2_zombie = Heartbeat(str(tmp_path / "hb"), process_id=2, metrics=reg2)
    hb2_zombie.fence_epoch = 0
    with pytest.raises(FencedOut):
        hb2_zombie.beat(3)
    assert reg2.get(tnames.CLUSTER_FENCE_REJECTS) == 1

    elastic = ElasticPlan(planner=planner, fleet=fleets[1],
                          devices_per_host=2, metrics=MetricsRegistry(),
                          tracer=tracer, ledger=ledger,
                          devices=["cpu"] * 6)
    plan = elastic.shrink([2])
    assert plan["survivors"] == [0, 1] and plan["step"] == 3
    assert plan["restaged"]
    stage_host(0)
    stage_host(1)
    assert all(not planner.pending(h) for h in (0, 1))
    assembled = np.asarray(np.lib.format.open_memmap(cache, mode="r"))
    assert np.array_equal(assembled, binning.apply_bins(mapper, x))

    step, manifest, payload = elastic.resume()
    assert step == 3 and manifest["oocore_cursor"] == staged_before_death
    mesh4 = elastic.mesh()
    assert mesh4.shape["data"] == 4
    p_rem = _params(num_iterations=3)

    def resume_fit(src):
        return fit_booster_distributed(
            x, y, p_rem, mesh=mesh4,
            init_booster=Booster.load_model_string(str(src["booster"])),
            init_base=float(src["base"]),
            init_margin=np.asarray(src["margin"], np.float32),
            iter_offset=int(src["iteration"]))

    resumed = resume_fit(payload)
    _same_booster(resumed, resume_fit(committed))
    assert resumed[0].n_trees == 6
    events = [r["event"] for r in ledger.records()
              if r.get("event") in (tnames.TRAIN_HOST_DEAD_EVENT,
                                    tnames.ELASTIC_PLAN_EVENT,
                                    tnames.ELASTIC_RESUME_EVENT)]
    assert events == [tnames.TRAIN_HOST_DEAD_EVENT,
                      tnames.ELASTIC_PLAN_EVENT,
                      tnames.ELASTIC_RESUME_EVENT]


_BEATER = """
import sys, time
sys.path.insert(0, {repo!r})
from mmlspark_tpu_torch.parallel.cluster import Heartbeat
hb = Heartbeat(sys.argv[1], process_id=int(sys.argv[2]))
for i in range(1200):
    hb.beat(i)
    time.sleep(0.05)
"""


def test_sigkill_subprocess_detected_by_leases(tmp_path):
    """Two child processes beat into a shared directory; one is SIGKILLed
    and the observer's monotonic leases age it out within the lease
    budget while the survivor stays live."""
    script = tmp_path / "beater.py"
    script.write_text(textwrap.dedent(_BEATER.format(repo=_REPO)))
    d = str(tmp_path / "hb")
    procs = [subprocess.Popen([sys.executable, str(script), d, str(pid)])
             for pid in (1, 2)]
    try:
        hb0 = Heartbeat(d, process_id=0)
        leases = HostLeases(hb0, lease_timeout_s=1.0, faults=None,
                            metrics=MetricsRegistry())
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            leases.check()
            if sorted(set(leases.live) - {0}) == [1, 2]:
                break
            time.sleep(0.1)
        assert sorted(set(leases.live) - {0}) == [1, 2]
        procs[1].send_signal(signal.SIGKILL)
        procs[1].wait()
        t0 = time.monotonic()
        dead = []
        while time.monotonic() < t0 + 15.0:
            dead = leases.check()
            if dead:
                break
            time.sleep(0.1)
        assert dead == [2]
        assert time.monotonic() - t0 < 15.0
        assert 1 in leases.live
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
