"""Multi-process cluster bootstrap, process-local data placement, and the
cross-process exchange of a data axis that spans processes.

Port of `mmlspark_tpu/parallel/cluster.py` on `torch.distributed`. The
reference joins a `jax.distributed` job and lets XLA's collectives cross
processes; here `initialize_cluster` forms a process group and the
exchange is explicit (`Exchange`). Typical multi-process flow, one
process per rank:

    from mmlspark_tpu_torch.parallel import cluster, data_mesh
    info = cluster.initialize_cluster(init_method="file:///shared/rdv",
                                      num_processes=2, process_id=rank)
    lo, hi = cluster.process_row_range(n_total)  # the rows THIS rank loads
    mesh = data_mesh(devices=[cluster.local_device()])  # spans the ranks
    ... fit_booster_distributed(x, y, params, mesh=mesh) ...
    cluster.barrier("trained")

The backend is chosen here and nowhere else (`choose_backend`): NCCL when
every rank has a card of its own, gloo otherwise, which includes several
ranks sharing one card (NCCL refuses two ranks on one GPU) and CPU jobs.
Gloo takes no CUDA tensor for an all-gather, so under gloo an exchange
of CUDA tensors goes through one pinned host buffer: a device-to-host
copy, the all-gather on the host, and one host-to-device copy. The route
is chosen by backend, never by catching an error.

Heartbeats, the epoch fence and `FencedOut` are file-based and need no
process group; `reliability.elastic.HostLeases` reads them.
"""
from __future__ import annotations

import datetime
import json
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..reliability import names as tnames
from ..reliability.faults import FaultInjector
from ..reliability.metrics import reliability_metrics
from ..reliability.policy import RetryPolicy


class ClusterInfo(NamedTuple):
    """This process's coordinates in the job."""
    process_id: int
    process_count: int
    local_device_count: int
    global_device_count: int


def _multi() -> bool:
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _rank() -> int:
    return dist.get_rank() if _multi() else 0


def _world() -> int:
    return dist.get_world_size() if _multi() else 1


def process_index() -> int:
    """This process's rank (0 without a multi-process job)."""
    return _rank()


def process_count() -> int:
    """The job's process count (1 without a multi-process job)."""
    return _world()


def backend_name() -> Optional[str]:
    """The process group's backend ("gloo" or "nccl"); None without a
    multi-process job."""
    return dist.get_backend() if _multi() else None


def choose_backend(num_processes: int,
                   local_processes: Optional[int] = None) -> str:
    """NCCL when every rank on this host has a card of its own, gloo
    otherwise. `local_processes` (default: the LOCAL_WORLD_SIZE variable
    a launcher sets, else `num_processes`, all ranks on this host) is the
    number of ranks that share this host's cards."""
    if local_processes is None:
        local_processes = int(os.environ.get("LOCAL_WORLD_SIZE",
                                             num_processes))
    if (torch.cuda.is_available() and dist.is_nccl_available()
            and torch.cuda.device_count() >= local_processes):
        return "nccl"
    return "gloo"


def _local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return _rank()


def local_device() -> torch.device:
    """The card this process trains on: under NCCL the rank's own card,
    under gloo card (rank mod visible cards), so that ranks share cards
    round robin; raises without a card (pass CPU devices to the mesh
    yourself)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: pass devices=['cpu'] to the mesh "
            "to run this process's positions on the CPU")
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def initialize_cluster(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None,
                       retry_policy: Optional[RetryPolicy] = None,
                       init_method: Optional[str] = None,
                       backend: Optional[str] = None,
                       timeout_s: float = 300.0) -> ClusterInfo:
    """Join (or start) the job's process group and report coordinates.

    `init_method` is any `torch.distributed` rendezvous URL
    (`file:///path`, `tcp://host:port`); `coordinator_address`
    ("host:port") is the reference's spelling of `tcp://host:port`. Both
    need `num_processes` and `process_id`. `backend` None takes
    `choose_backend`'s. Idempotent: a process already in a group, or a
    one-process job, returns its coordinates without a rendezvous, so
    library code can call it unconditionally.

    A failed rendezvous raises: it never falls back to N disconnected
    jobs. `retry_policy` retries it (workers racing the coordinator
    coming up), each retry counted under `cluster.rendezvous_retries`;
    by default one strict attempt, so a misconfiguration surfaces at
    once."""
    multi = (init_method is not None or coordinator_address is not None
             or num_processes not in (None, 1))
    if multi and not dist.is_initialized():
        if num_processes is None or process_id is None:
            raise ValueError("a multi-process job needs num_processes and "
                             "process_id")
        method = init_method or f"tcp://{coordinator_address}"
        be = backend or choose_backend(int(num_processes))
        if be == "nccl":
            torch.cuda.set_device(int(os.environ.get(
                "LOCAL_RANK", process_id)) % torch.cuda.device_count())

        def _join():
            dist.init_process_group(
                be, init_method=method, world_size=int(num_processes),
                rank=int(process_id),
                timeout=datetime.timedelta(seconds=timeout_s))

        if retry_policy is not None:
            retry_policy.call(
                _join, retry_on=(RuntimeError, TimeoutError),
                on_retry=lambda att, e: reliability_metrics.inc(
                    tnames.CLUSTER_RENDEZVOUS_RETRIES))
        else:
            _join()
    # a rank of a multi-process job trains on one card (`local_device`)
    n_local = 1 if _multi() else max(torch.cuda.device_count(), 1)
    return ClusterInfo(process_id=_rank(), process_count=_world(),
                       local_device_count=n_local,
                       global_device_count=n_local * _world())


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_row_range(n_rows: int, process_id: Optional[int] = None,
                      process_count: Optional[int] = None):
    """[lo, hi) of a global row space this process should load: the
    contiguous-block analog of Spark's partition assignment. Remainder
    rows go to the leading processes, so sizes differ by at most 1."""
    pid = _rank() if process_id is None else int(process_id)
    n_proc = _world() if process_count is None else int(process_count)
    base, extra = divmod(int(n_rows), n_proc)
    lo = pid * base + min(pid, extra)
    return lo, lo + base + (1 if pid < extra else 0)


def padded_process_rows(n_rows: int, mesh, process_id: Optional[int] = None,
                        process_count: Optional[int] = None):
    """Equal-block row assignment over a mesh whose data axis spans the
    processes: every process holds the SAME block of rows, divisible by
    its share of the positions. Returns (lo, hi, block): load rows
    [lo, hi) and zero-pad to `block`; the padded global size is block *
    process_count. Padding rows are the caller's to mask (the GBDT
    path's zero-weight, zero-presence padding, `distributed.py`)."""
    from .mesh import DATA_AXIS
    pid = _rank() if process_id is None else int(process_id)
    n_proc = _world() if process_count is None else int(process_count)
    per_proc = max(mesh.shape[DATA_AXIS] // n_proc, 1)
    block = -(-int(n_rows) // n_proc)                     # ceil
    block = -(-block // per_proc) * per_proc
    lo = min(pid * block, n_rows)
    return lo, min(lo + block, n_rows), block


def global_array(mesh, local_rows, axis_name: Optional[str] = None) -> list:
    """This process's rows placed on its own positions of the mesh: one
    tensor per local position, each on its device (the reference's global
    `jax.Array` stitched from per-process blocks; here each process holds
    tensors for its positions only). One process: the whole array split
    over the positions."""
    from .mesh import DATA_AXIS, row_sharding
    t = torch.as_tensor(np.asarray(local_rows)) \
        if not torch.is_tensor(local_rows) else local_rows
    return row_sharding(mesh, axis_name or DATA_AXIS, ndim=t.dim()).put(t)


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point. A no-op with one
    process."""
    if not _multi():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def broadcast_from_leader(value):
    """Every process returns process 0's value: an array comes back as a
    numpy array, any other picklable value (a `BinMapper`) as itself.
    The identity with one process."""
    if _multi():
        box = [value if _rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        value = box[0]
    if isinstance(value, (np.ndarray, int, float)) or \
            type(value) in (list, tuple):
        return np.asarray(value)
    return value


def all_gather_object(value) -> list:
    """Every process's `value`, in process order (`[value]` with one
    process)."""
    if not _multi():
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


class Exchange:
    """The all-gather of a data axis that spans processes: each process
    hands in its positions' tensors stacked, (L, ...), and every process
    gets all positions', (P * L, ...), in global position order, on the
    device it handed in. Under NCCL the gather runs on the card; under
    gloo a CPU tensor is gathered as it is and a CUDA one through pinned
    host buffers kept per shape (`choose_backend`; the module
    docstring).

    `stats()` reads what the exchanges cost: calls, bytes received, the
    wall inside the exchange (`seconds`) and, for CUDA tensors, the wait
    for the card to finish the work that produced the tensor
    (`wait_seconds`, spent before the exchange starts, outside
    `seconds`; the host-staged route splits `seconds` into its copies and
    the collective). Each call is counted under `cluster.exchanges` and
    timed under `cluster.exchange`."""

    def __init__(self):
        if not _multi():
            raise RuntimeError("an Exchange needs a multi-process job "
                               "(initialize_cluster)")
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.host_staged = dist.get_backend() != "nccl"
        self._buffers: dict = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0
        self.wait_seconds = 0.0
        self.copy_seconds = 0.0
        self.gather_seconds = 0.0

    def stats(self) -> dict:
        """`seconds` = `copy_seconds` (the host-staged route's copies to
        and from the card) + `gather_seconds` (the collective, the wait
        for the slowest process included)."""
        return dict(calls=self.calls, bytes=self.bytes,
                    seconds=self.seconds, wait_seconds=self.wait_seconds,
                    copy_seconds=self.copy_seconds,
                    gather_seconds=self.gather_seconds)

    def _host_pair(self, shape, dtype):
        """(send, receive) pinned host buffers for one shape, kept for the
        next exchange of that shape (a level's histograms repeat every
        tree)."""
        key = (tuple(shape), dtype)
        pair = self._buffers.get(key)
        if pair is None:
            send = torch.empty(shape, dtype=dtype, pin_memory=True)
            recv = torch.empty((self.world,) + tuple(shape), dtype=dtype,
                               pin_memory=True)
            pair = self._buffers[key] = (send, recv)
        return pair

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """(L, ...) local -> (world * L, ...) in process order."""
        local = local.contiguous()
        dev = local.device
        on_card = dev.type == "cuda"
        if on_card:
            t0 = time.perf_counter()
            torch.cuda.synchronize(dev)
            self.wait_seconds += time.perf_counter() - t0
        t0 = time.perf_counter()
        copy_s = 0.0
        if on_card and not self.host_staged:
            out = torch.empty((self.world,) + tuple(local.shape),
                              dtype=local.dtype, device=dev)
            dist.all_gather_into_tensor(out, local)
            torch.cuda.synchronize(dev)
        elif on_card:
            send, recv = self._host_pair(local.shape, local.dtype)
            send.copy_(local)                   # waits for the copy
            t1 = time.perf_counter()
            dist.all_gather(list(recv.unbind(0)), send)
            t2 = time.perf_counter()
            out = recv.to(dev)      # one copy from the pinned buffer
            torch.cuda.synchronize(dev)
            copy_s = (t1 - t0) + (time.perf_counter() - t2)
        else:
            out = torch.empty((self.world,) + tuple(local.shape),
                              dtype=local.dtype)
            dist.all_gather(list(out.unbind(0)), local)
        dt = time.perf_counter() - t0
        self.calls += 1
        self.bytes += out.numel() * out.element_size()
        self.seconds += dt
        self.copy_seconds += copy_s
        self.gather_seconds += dt - copy_s
        reliability_metrics.inc(tnames.CLUSTER_EXCHANGES)
        reliability_metrics.inc(tnames.CLUSTER_EXCHANGE_BYTES,
                                out.numel() * out.element_size())
        reliability_metrics.observe_ms(tnames.CLUSTER_EXCHANGE, dt * 1e3)
        return out.reshape((-1,) + tuple(local.shape[1:]))

    def gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """This process's rows of a per-row tensor, concatenated with every
        other process's in process order (counts may differ)."""
        n = torch.tensor([[local.shape[0]]], dtype=torch.int64,
                         device=local.device)
        sizes = [int(s) for s in self.gather(n).reshape(-1).tolist()]
        width = max(sizes)
        pad = local.new_zeros((width - local.shape[0],) + local.shape[1:])
        full = self.gather(torch.cat([local, pad])[None])
        return torch.cat([full[i, :s] for i, s in enumerate(sizes)])


class FencedOut(RuntimeError):
    """A beat was rejected by the epoch fence: this host was declared dead
    (`reliability.elastic.HostLeases`) and its fencing token is stale.
    The row is NOT written: a zombie resuming after its death verdict
    must not corrupt the survivor plan. A restarted process adopts the
    current fence at `Heartbeat.__init__` (or via `adopt_fence()`) and
    beats normally."""


# shared fence table in the heartbeat directory: process_id -> minimum
# fence epoch a beat must carry to be accepted
_FENCES_FILE = "fences.json"
# another host's leaked beat tmp is swept only once it is older than any
# plausible in-flight write (our OWN stale tmps are swept unconditionally)
_TMP_STALE_S = 60.0


def read_fences(directory: str) -> dict:
    """The fence table ({process_id: epoch}); empty when absent or torn."""
    try:
        with open(os.path.join(directory, _FENCES_FILE)) as f:
            raw = json.load(f)
        return {int(k): int(v) for k, v in raw.items()}
    except (OSError, ValueError, AttributeError):
        return {}


def bump_fence(directory: str, process_id: int) -> int:
    """Raise `process_id`'s required fence epoch (atomic tmp + replace)
    and return the new value. Observers racing the read-modify-write each
    land a value above the zombie's adopted epoch, so the fence holds
    whichever write wins."""
    fences = read_fences(directory)
    pid = int(process_id)
    fences[pid] = fences.get(pid, 0) + 1
    tmp = os.path.join(directory, f"{_FENCES_FILE}.{os.getpid()}.tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({str(k): v for k, v in sorted(fences.items())}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, _FENCES_FILE))
    return fences[pid]


class Heartbeat:
    """Per-process heartbeat file: how a restarted process detects that it
    is REJOINING a job, and what peers read for liveness and stragglers.

    Each process writes `heartbeat_<pid>.json` (atomic tmp + replace) with
    its last completed epoch; a process that starts and finds its own
    file knows it crashed or was preempted mid-job: the prior epoch is
    `resume_epoch` and the `cluster.resume_epoch` gauge (+
    `cluster.rejoins`). `beat(epoch)` fires the `cluster.heartbeat` fault
    site; `clear()` removes the file on a clean finish.

    Beats are epoch-fenced: every row carries the fence epoch this
    instance adopted at construction, and `beat()` re-checks the shared
    fence table before writing, so a zombie declared dead by `HostLeases`
    gets `FencedOut` instead of a write, while a real restart (a fresh
    instance) adopts the bumped fence and rejoins. `faults=None` injects
    nothing."""

    def __init__(self, directory: str, process_id: Optional[int] = None,
                 faults: Optional[FaultInjector] = None, metrics=None):
        os.makedirs(directory, exist_ok=True)
        if process_id is None:
            process_id = _rank()
        self.directory = directory
        self.process_id = int(process_id)
        self.path = os.path.join(directory,
                                 f"heartbeat_{self.process_id}.json")
        self._metrics = metrics if metrics is not None else reliability_metrics
        self._faults = faults
        self._sweep_stale_tmps()
        self.fence_epoch = self.adopt_fence()
        prior = self.read()
        self.resume_epoch: Optional[int] = (
            None if prior is None else int(prior.get("epoch", 0)))
        if prior is not None:
            self._metrics.set_gauge(tnames.CLUSTER_RESUME_EPOCH,
                                    self.resume_epoch)
            self._metrics.inc(tnames.CLUSTER_REJOINS)

    def _sweep_stale_tmps(self) -> None:
        """Remove beat tmp files leaked by a crash between the tmp write
        and its os.replace: our own unconditionally (no live writer can
        exist at construction), another host's only past _TMP_STALE_S."""
        own_prefix = f"heartbeat_{self.process_id}.json."
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return
        now = time.time()
        swept = 0
        for fname in names:
            if not (fname.startswith("heartbeat_")
                    and fname.endswith(".tmp")):
                continue
            path = os.path.join(self.directory, fname)
            try:
                if not fname.startswith(own_prefix):
                    if now - os.stat(path).st_mtime < _TMP_STALE_S:
                        continue
                os.remove(path)
                swept += 1
            except OSError:
                continue
        if swept:
            self._metrics.inc(tnames.CLUSTER_HEARTBEAT_TMP_SWEPT, swept)

    def adopt_fence(self) -> int:
        """(Re-)read the fence table and adopt this process's current
        epoch: the rejoin path after a false-positive death verdict."""
        self.fence_epoch = read_fences(self.directory).get(
            self.process_id, 0)
        return self.fence_epoch

    @property
    def rejoining(self) -> bool:
        """Did this process find its own prior heartbeat at startup?"""
        return self.resume_epoch is not None

    def beat(self, epoch: int, stats: Optional[dict] = None) -> None:
        """Atomically record the last completed epoch (a kill mid-beat
        leaves the previous beat, never a torn file). `stats`, a small
        JSON-able dict, rides along for the peers: the supervisor's
        StepClock `{"step_p50_ms", "steps", "goodput"}`, which the
        straggler detector reads."""
        if self._faults is not None:
            self._faults.perturb("cluster.heartbeat")
        required = read_fences(self.directory).get(self.process_id, 0)
        if required > self.fence_epoch:
            self._metrics.inc(tnames.CLUSTER_FENCE_REJECTS)
            raise FencedOut(
                f"process {self.process_id} beat with fence epoch "
                f"{self.fence_epoch} < required {required} (declared "
                f"dead); adopt_fence() to rejoin as a new incarnation")
        tmp = f"{self.path}.{os.getpid()}.tmp"
        row = {"process_id": self.process_id, "epoch": int(epoch),
               "time": time.time(), "fence": self.fence_epoch}
        if stats:
            row["stats"] = dict(stats)
        with open(tmp, "w") as f:
            json.dump(row, f)
        os.replace(tmp, self.path)

    def read(self, process_id: Optional[int] = None) -> Optional[dict]:
        """This (or another) process's last heartbeat; None when absent or
        unreadable."""
        path = self.path if process_id is None else os.path.join(
            self.directory, f"heartbeat_{int(process_id)}.json")
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def read_all(self, max_age_s: Optional[float] = None) -> list:
        """Every process's last heartbeat in the directory, by file name;
        unreadable files are skipped. Each row carries `age_s`, seconds
        since its file's mtime on THIS observer's clock; rows older than
        `max_age_s` are dropped (a crashed host's frozen row would
        otherwise return forever), and rows with a stale fence token (a
        zombie write that raced its verdict) always are."""
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return []
        fences = read_fences(self.directory)
        rows = []
        for fname in names:
            if not (fname.startswith("heartbeat_")
                    and fname.endswith(".json")):
                continue
            path = os.path.join(self.directory, fname)
            try:
                with open(path) as f:
                    row = json.load(f)
                age = max(time.time() - os.stat(path).st_mtime, 0.0)
            except (OSError, ValueError):
                continue
            try:
                pid = int(row.get("process_id"))
                fence = int(row.get("fence", 0))
            except (TypeError, ValueError):
                pid, fence = None, 0
            if pid is not None and fence < fences.get(pid, 0):
                continue
            if max_age_s is not None and age > max_age_s:
                continue
            row["age_s"] = age
            rows.append(row)
        return rows

    def clear(self) -> None:
        """Remove the heartbeat after a clean finish, so the next start is
        a fresh job, not a rejoin."""
        try:
            os.remove(self.path)
        except OSError:
            pass
