"""Elastic multi-process training: lease-based liveness, coordinated fleet
checkpoints, and shrink-resume.

Port of the reference's `reliability/elastic.py` (which imports no JAX).
A slow host loses its chunks (`telemetry.goodput.StragglerDetector` ->
`data.ChunkPlanner.reassign`); this module handles a DEAD one:

1. **HostLeases**: each observed `Heartbeat.beat()` renews a lease on the
   OBSERVER's monotonic clock; a lease aging past `lease_timeout_s` is a
   death verdict. No clock of another host is compared: a host is dead
   when this observer has seen no new beat content for the timeout. The
   verdict bumps the shared epoch fence (`parallel.cluster.bump_fence`),
   so a zombie that resumes beating gets `FencedOut`; the
   `cluster.hosts.{live,dead}` gauges stay current.
2. **FleetCheckpoint**: two-phase commit over a shared directory. Phase
   1, every host's `CheckpointManager` lands its step-k shard under
   `host_<pid>/` (digested, fsynced); phase 2, the leader (lowest live
   process id, re-elected by `leader()` on a death) writes
   `manifest_step_<k>.json` naming every member shard's digests plus, for
   example, the out-of-core cursor. Restore refuses torn or partial
   manifests (a member missing, a digest mismatch) and falls back to the
   last fully committed fleet step.
3. **ElasticPlan**: on a death verdict, re-derive the chunk assignment
   over the survivors (`ChunkPlanner.remove_hosts`: the dead hosts'
   unfinished chunks become re-reads of the shared spill cache for the
   inheritors), the survivors' mesh (`mesh()`), and the resume point from
   the committed manifest.

Each verdict, plan and resume is an event (`train.host.dead`,
`elastic.plan`, `elastic.resume`) handed to the `tracer` given
(`.event(name, **attrs)`), else the process tracer, and appended to a
run `ledger` (`.append_event(name, **attrs)`, e.g.
`telemetry.lineage.RunLedger`) where the caller gives one.
`faults=None` injects nothing.
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional, Sequence

from ..telemetry.spans import get_tracer
from ..utils.checkpoint import CheckpointManager, _fsync_path
from . import names as tnames
from .faults import FaultInjector, InjectedFault
from .metrics import reliability_metrics

logger = logging.getLogger(__name__)


def _journal(tracer, ledger, event: str, **attrs) -> None:
    """Hand an event to the tracer given (else the process tracer) and to
    the run ledger given (a failing journal never affects control)."""
    (tracer if tracer is not None else get_tracer()).event(event, **attrs)
    if ledger is not None:
        try:
            ledger.append_event(event, **attrs)
        except Exception:  # noqa: BLE001 - journal, not control
            pass


class HostLeases:
    """Observer-local lease table over a shared heartbeat directory.

    Any observed CHANGE in a host's beat row (epoch, stamp, stats) renews
    its lease at `clock()`: by default `time.monotonic`, injectable so
    tests drive expiry without sleeping. Driven from the supervisor's
    beat; `check()` never raises.

    A verdict is a TRANSITION: the host moves to the dead set once, the
    `train.host.dead` event fires once, and the shared fence is bumped so
    the dead incarnation's further beats raise `FencedOut`. A host that
    really restarts adopts the bumped fence and beats again, but this
    observer's dead set stays as it is, matching the shrunk plan it
    actuated."""

    def __init__(self, heartbeat, lease_timeout_s: float = 30.0,
                 clock=None, faults: Optional[FaultInjector] = None,
                 metrics=None, tracer=None, ledger=None):
        self.heartbeat = heartbeat
        self.lease_timeout_s = float(lease_timeout_s)
        self.clock = clock if clock is not None else time.monotonic
        self.faults = faults
        self.metrics = metrics if metrics is not None else reliability_metrics
        self._tracer = tracer
        self._ledger = ledger
        self._self = getattr(heartbeat, "process_id", None)
        self._leases: dict = {}       # pid -> (row fingerprint, renewed_at)
        self._dead: set = set()

    @property
    def live(self) -> list:
        return sorted(set(self._leases) - self._dead)

    @property
    def dead(self) -> list:
        return sorted(self._dead)

    @staticmethod
    def _fingerprint(row: dict) -> str:
        return json.dumps({k: v for k, v in row.items() if k != "age_s"},
                          sort_keys=True, default=str)

    def check(self) -> list:
        """One liveness pass; returns the hosts NEWLY declared dead. Fires
        the `cluster.lease.expire` fault site once per (round, host) in
        sorted host order: kind `expire` forces a false-positive verdict
        on that host, kind `error` skips the round."""
        try:
            rows = {}
            for row in self.heartbeat.read_all():
                try:
                    rows[int(row.get("process_id"))] = row
                except (TypeError, ValueError):
                    continue
        except Exception:  # noqa: BLE001 - a torn directory loses one pass
            return []
        now = self.clock()
        newly = []
        for pid in sorted(set(rows) | set(self._leases)):
            if pid in self._dead:
                continue
            row = rows.get(pid)
            prev = self._leases.get(pid)
            if row is not None:
                fp = self._fingerprint(row)
                if prev is None or prev[0] != fp:
                    prev = (fp, now)       # new content observed: renew
                    self._leases[pid] = prev
            if prev is None:
                continue
            age = now - prev[1]
            forced = None
            if self.faults is not None:
                try:
                    forced = self.faults.perturb("cluster.lease.expire")
                except InjectedFault:
                    return newly           # injected error: skip the round
            expired = age > self.lease_timeout_s or (
                forced is not None and forced.kind == "expire")
            if expired and pid != self._self:
                self._declare_dead(pid, age)
                newly.append(pid)
        self.metrics.set_gauge(tnames.CLUSTER_HOSTS_LIVE, len(self.live))
        self.metrics.set_gauge(tnames.CLUSTER_HOSTS_DEAD, len(self._dead))
        return newly

    def _declare_dead(self, pid: int, age: float) -> None:
        self._dead.add(pid)
        # lazy: parallel imports this package, so a module-level import
        # here would cycle
        from ..parallel.cluster import bump_fence
        try:
            # the fence bump IS the verdict's write barrier
            bump_fence(self.heartbeat.directory, pid)
        except OSError as e:
            logger.warning("fence bump for dead host %d failed (%s: %s)",
                           pid, type(e).__name__, e)
        _journal(self._tracer, self._ledger, tnames.TRAIN_HOST_DEAD_EVENT,
                 host=pid, age_s=round(age, 3),
                 lease_timeout_s=self.lease_timeout_s)
        logger.warning("host %d declared dead: lease aged %.3fs past "
                       "%.3fs budget", pid, age, self.lease_timeout_s)


def leader(live_hosts: Sequence[int]) -> int:
    """The fleet leader is the lowest live process id; re-election on a
    death is this over the survivors."""
    hosts = sorted(int(h) for h in live_hosts)
    if not hosts:
        raise ValueError("leader() of an empty host set")
    return hosts[0]


class FleetCheckpoint:
    """Two-phase-commit fleet checkpoint over one shared directory.

        <dir>/host_<pid>/step_<k>/payload.npz+meta.json   (phase 1)
        <dir>/manifest_step_<k>.json                      (phase 2)

    `manager` is this host's shard `CheckpointManager` (hand it to an
    `AsyncCheckpointWriter` as on one host: the shard write IS phase 1).
    `commit()` is the leader's and refuses until every live member's
    step-k shard is on disk with digests; the manifest write is atomic
    (tmp + replace + fsync) and fires the `elastic.commit` fault site
    between the tmp write and the replace, so a leader killed mid-commit
    leaves no manifest and the next leader commits again.
    `latest_committed()` and `restore()` verify every member digest and
    fall back past torn or partial manifests."""

    def __init__(self, directory: str, process_id: int,
                 max_to_keep: int = 3,
                 faults: Optional[FaultInjector] = None, metrics=None):
        self.directory = directory
        self.process_id = int(process_id)
        os.makedirs(directory, exist_ok=True)
        self.metrics = metrics if metrics is not None else reliability_metrics
        self.faults = faults
        self.manager = CheckpointManager(
            self._host_dir(self.process_id), max_to_keep=max_to_keep)

    def _host_dir(self, pid: int) -> str:
        return os.path.join(self.directory, f"host_{int(pid)}")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"manifest_step_{int(step)}.json")

    def save_shard(self, step: int, payload: dict) -> None:
        """Phase 1: this host's step-k shard (digested and fsynced by the
        manager)."""
        self.manager.save(int(step), payload)

    def _member_digests(self, pid: int, step: int) -> Optional[dict]:
        """The recorded `_digests` of `pid`'s step-k shard; None when the
        shard is absent or its meta is torn (phase 1 not landed)."""
        try:
            with open(os.path.join(self._host_dir(pid), f"step_{int(step)}",
                                   "meta.json")) as f:
                meta = json.load(f)
            digests = meta.get("_digests")
            if (isinstance(digests, dict) and digests
                    and all(isinstance(v, str) for v in digests.values())):
                return digests
        except (OSError, ValueError):
            pass
        return None

    def commit(self, step: int, live_hosts: Sequence[int],
               extra: Optional[dict] = None) -> bool:
        """Phase 2, the leader's manifest write. False (nothing written)
        when this host is not the leader of `live_hosts` or a member's
        step-k shard has not landed; True once the manifest is durable.
        `extra` rides in the manifest as it is (the out-of-core cursor)."""
        hosts = sorted(int(h) for h in live_hosts)
        if not hosts or self.process_id != leader(hosts):
            return False
        members = {}
        for pid in hosts:
            digests = self._member_digests(pid, step)
            if digests is None:
                return False          # phase 1 incomplete: try again later
            members[str(pid)] = digests
        manifest = {"step": int(step), "leader": self.process_id,
                    "hosts": members}
        if extra:
            manifest.update(extra)
        path = self._manifest_path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        if self.faults is not None:
            # a `crash` here is the leader dying mid-commit: the tmp stays,
            # no manifest exists, the next leader commits again
            self.faults.perturb("elastic.commit")
        os.replace(tmp, path)
        _fsync_path(self.directory)
        self.metrics.inc(tnames.ELASTIC_MANIFEST_COMMITS)
        return True

    def committed_steps(self) -> list:
        steps = []
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return []
        for name in names:
            if name.startswith("manifest_step_") and name.endswith(".json"):
                try:
                    steps.append(int(name[len("manifest_step_"):-5]))
                except ValueError:
                    continue
        return sorted(steps)

    def _verify_manifest(self, step: int) -> Optional[dict]:
        """One manifest parsed and verified; None when torn or partial (a
        named member's shard missing or carrying other digests)."""
        try:
            with open(self._manifest_path(step)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        hosts = manifest.get("hosts")
        if (not isinstance(hosts, dict) or not hosts
                or int(manifest.get("step", -1)) != int(step)):
            return None
        for pid, want in sorted(hosts.items()):
            try:
                got = self._member_digests(int(pid), step)
            except (TypeError, ValueError):
                return None
            if got is None or got != want:
                return None
        return manifest

    def latest_committed(self):
        """(step, manifest) of the newest fully committed fleet step, or
        None. Torn or partial manifests are counted
        (`elastic.manifest.rejected`) and skipped."""
        for step in sorted(self.committed_steps(), reverse=True):
            manifest = self._verify_manifest(step)
            if manifest is not None:
                return step, manifest
            self.metrics.inc(tnames.ELASTIC_MANIFEST_REJECTED)
            logger.warning("fleet manifest step %d torn/partial; falling "
                           "back", step)
        return None

    def restore(self, pid: Optional[int] = None):
        """(step, manifest, payload) of the last committed fleet step, the
        payload `pid`'s digest-verified shard (default: this host's); None
        when no step is committed."""
        committed = self.latest_committed()
        if committed is None:
            return None
        step, manifest = committed
        who = self.process_id if pid is None else int(pid)
        mgr = self.manager if who == self.process_id else \
            CheckpointManager(self._host_dir(who))
        return step, manifest, mgr.restore(step=step)


class ElasticPlan:
    """Survivor-side shrink-resume: turns a death verdict into (a) a
    re-derived chunk plan, (b) the survivors' mesh and (c) a resume point
    from the committed fleet manifest, journaling `elastic.plan` on the
    shrink and `elastic.resume` on the resume (after the verdict's
    `train.host.dead`). `devices`: the devices the survivors' positions
    are drawn from (None: the visible cards)."""

    def __init__(self, planner=None, fleet: Optional[FleetCheckpoint] = None,
                 devices_per_host: int = 1, metrics=None, tracer=None,
                 ledger=None, devices=None):
        self.planner = planner
        self.fleet = fleet
        self.devices_per_host = max(int(devices_per_host), 1)
        self.metrics = metrics if metrics is not None else reliability_metrics
        self._tracer = tracer
        self._ledger = ledger
        self.devices = devices
        self.survivors: list = [] if planner is None else list(planner.hosts)
        self.restaged: dict = {}

    def shrink(self, dead: Sequence[int]) -> dict:
        """Re-derive the assignment over the survivors: the dead hosts'
        unfinished chunks drain to the inheritors (`remove_hosts`) and the
        dead hosts leave the rotation for good. Returns the plan it
        journals as `elastic.plan`."""
        dead = sorted(int(h) for h in dead)
        if self.planner is not None:
            self.restaged = dict(self.planner.remove_hosts(dead))
            self.survivors = list(self.planner.hosts)
        else:
            self.survivors = [h for h in self.survivors if h not in dead]
        committed = self.fleet.latest_committed() if self.fleet is not None \
            else None
        plan = {"dead": dead, "survivors": list(self.survivors),
                "restaged": sorted(self.restaged),
                "step": None if committed is None else committed[0]}
        self.metrics.inc(tnames.ELASTIC_SHRINKS)
        _journal(self._tracer, self._ledger, tnames.ELASTIC_PLAN_EVENT,
                 **plan)
        return plan

    def mesh(self):
        """The survivors' 1-D data mesh: `devices_per_host` positions per
        survivor. In one process (the form the tests drive) it is a mesh
        of that many positions; a job of several processes forms its
        process group again over the survivors
        (`parallel.cluster.initialize_cluster`) before a mesh spans
        them."""
        from ..parallel.mesh import data_mesh
        n = len(self.survivors) * self.devices_per_host
        return data_mesh(n if n else None, devices=self.devices)

    def resume(self, pid: Optional[int] = None):
        """(step, manifest, payload) from the committed fleet manifest
        (None without one), journaled as `elastic.resume`."""
        out = self.fleet.restore(pid=pid) if self.fleet is not None else None
        step = None if out is None else out[0]
        self.metrics.inc(tnames.ELASTIC_RESUMES)
        _journal(self._tracer, self._ledger, tnames.ELASTIC_RESUME_EVENT,
                 step=step, survivors=list(self.survivors))
        return out
