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
is chosen by backend, never by catching an error. Point-to-point messages
always go over gloo (`Exchange`), under NCCL on a gloo group of their
own.

The LM trainers and ring attention move tensors between processes inside
autograd (`Link`): tagged point-to-point messages only (`MessageTags`),
the sends non-blocking and held until the step ends, each message node
threaded on one token chain, so that the backward runs every rank's
message nodes in the reverse of its forward order and the ranks never
wait on each other in a cycle. Sums that every rank must hold bit for bit
(gradients of replicated weights, the loss) are `Exchange.ordered_sum`:
every part gathered and added in rank order, never gloo's all_reduce,
whose order may differ between ranks.

Heartbeats, the epoch fence and `FencedOut` are file-based and need no
process group; `reliability.elastic.HostLeases` reads them.
"""
from __future__ import annotations

import contextlib
import datetime
import json
import math
import os
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import set_checkpoint_early_stop

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
    global _GLOO_GROUP
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _GLOO_GROUP = None


# the gloo group of every process that carries the messages of a job
# whose own group is NCCL's (`Exchange`)
_GLOO_GROUP = None


def _gloo_group():
    """The job's gloo group for messages, formed on first use (a
    collective: every process's first Exchange forms it)."""
    global _GLOO_GROUP
    if _GLOO_GROUP is None:
        _GLOO_GROUP = dist.new_group(backend="gloo")
    return _GLOO_GROUP


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
    """Tensors between the processes of a job: the all-gather of a data
    axis that spans processes (`gather`), tagged point-to-point messages
    (`send`, `recv`, `wait_sends`) and the ordered sum (`ordered_sum`).

    `gather`: each process hands in its positions' tensors stacked,
    (L, ...), and every process gets all positions', (P * L, ...), in
    global position order, on the device it handed in. Under NCCL the
    gather runs on the card; under gloo a CPU tensor goes as it is and a
    CUDA one through pinned host buffers kept per shape (`choose_backend`;
    the module docstring).

    The messages (and so the ordered sums) always go over gloo, a CUDA
    tensor through pinned host buffers; under NCCL on a gloo group of the
    same processes that the job's first Exchange forms (a collective, as
    building a mesh is). NCCL runs both directions between two processes
    on one stream, so two processes that each post a send before their
    receive, as the ordered sum, the ring and the gather do, would wait
    on each other once a message outgrows NCCL's buffer.

    `stats()` reads what the exchanges cost: under `primitives`, for each
    of gather, send, recv and sum, its calls, bytes (received for the
    gather), seconds, `copy_seconds` (to and from the card),
    `wire_seconds` (the transfer, the wait for the peer included) and,
    for CUDA tensors, `wait_seconds`, the wait for the card to finish the
    work that produced the tensor (spent before the exchange starts,
    outside `seconds`); the all-gather's also at the top level (`calls`,
    `bytes`, `seconds`, `wait_seconds`, `copy_seconds`, and
    `gather_seconds` its wire seconds). Each call is counted under
    `cluster.exchanges` and `cluster.exchange_bytes` and timed under
    `cluster.exchange`."""

    PRIMITIVES = ("gather", "send", "recv", "sum")

    def __init__(self):
        if not _multi():
            raise RuntimeError("an Exchange needs a multi-process job "
                               "(initialize_cluster)")
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        self.host_staged = dist.get_backend() != "nccl"
        self._messages_group = None if self.host_staged else _gloo_group()
        self._buffers: dict = {}
        self._send_pool: dict = {}     # (shape, dtype) -> free pinned buffers
        self._pending: list = []  # (work, pinned buffer, primitive, payload)
        self._recv_lock = threading.Lock()
        self.reset_stats()

    def reset_stats(self) -> None:
        self.primitive_stats = {
            p: dict(calls=0, bytes=0, seconds=0.0, copy_seconds=0.0,
                    wire_seconds=0.0, wait_seconds=0.0)
            for p in self.PRIMITIVES}

    def stats(self) -> dict:
        """Every primitive's costs under `primitives`, the all-gather's
        also at the top level (class docstring): there `seconds` =
        `copy_seconds` (the host-staged route's copies to and from the
        card) + `gather_seconds` (the collective, the wait for the
        slowest process included)."""
        g = self.primitive_stats["gather"]
        return dict(calls=g["calls"], bytes=g["bytes"],
                    seconds=g["seconds"], wait_seconds=g["wait_seconds"],
                    copy_seconds=g["copy_seconds"],
                    gather_seconds=g["wire_seconds"],
                    primitives={p: dict(v) for p, v in
                                self.primitive_stats.items()})

    def _book(self, primitive, nbytes, seconds, copy_s=0.0, wait_s=0.0,
              call=True) -> None:
        rec = self.primitive_stats[primitive]
        rec["calls"] += int(call)
        rec["bytes"] += int(nbytes)
        rec["seconds"] += seconds
        rec["copy_seconds"] += copy_s
        rec["wire_seconds"] += seconds - copy_s
        rec["wait_seconds"] += wait_s
        if call:
            reliability_metrics.inc(tnames.CLUSTER_EXCHANGES)
        if nbytes:
            reliability_metrics.inc(tnames.CLUSTER_EXCHANGE_BYTES,
                                    int(nbytes))
        if seconds:
            reliability_metrics.observe_ms(tnames.CLUSTER_EXCHANGE,
                                           seconds * 1e3)

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

    def _card_wait(self, t) -> float:
        """Wait for the card to finish the work that produced `t` (the
        copies out of it must come after): the seconds waited."""
        if t.device.type != "cuda":
            return 0.0
        t0 = time.perf_counter()
        torch.cuda.synchronize(t.device)
        return time.perf_counter() - t0

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """(L, ...) local -> (world * L, ...) in process order."""
        local = local.contiguous()
        dev = local.device
        on_card = dev.type == "cuda"
        wait_s = self._card_wait(local)
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
        self._book("gather", out.numel() * out.element_size(),
                   time.perf_counter() - t0, copy_s, wait_s)
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

    def send(self, tensor: torch.Tensor, dst: int, tag: int,
             primitive: str = "send", call: bool = True) -> None:
        """Post `tensor` to process `dst` under `tag` and return at once:
        the message is held (and, from the card, its pinned staging copy,
        taken after the card finished the tensor) until `wait_sends`. A
        recv of the same tag on `dst` takes it, in whatever order the
        tags arrive (gloo matches tags)."""
        t = tensor.detach().contiguous()
        wait_s = self._card_wait(t)
        t0 = time.perf_counter()
        copy_s, buf = 0.0, None
        if t.device.type == "cuda":
            free = self._send_pool.get((tuple(t.shape), t.dtype))
            buf = free.pop() if free else torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            copy_s = time.perf_counter() - t0
            payload = buf
        else:
            # a private copy: the caller may write into its tensor (an
            # accumulated gradient) before the message has left
            payload = t.clone() if t.data_ptr() == tensor.data_ptr() else t
        work = dist.isend(payload, int(dst), tag=int(tag),
                          group=self._messages_group)
        self._pending.append((work, buf, primitive, payload))
        self._book(primitive, t.numel() * t.element_size(),
                   time.perf_counter() - t0, copy_s, wait_s, call)

    def recv(self, shape, dtype, device, src: int, tag: int,
             primitive: str = "recv", call: bool = True) -> torch.Tensor:
        """The message `src` sent under `tag`, a new tensor of `shape` and
        `dtype` on `device`; blocks until it arrived (and, to the card,
        until its copy from the pinned buffer is done)."""
        dev = torch.device(device)
        t0 = time.perf_counter()
        copy_s = 0.0
        if dev.type == "cuda":
            with self._recv_lock:
                key = ("recv", tuple(shape), dtype)
                buf = self._buffers.get(key)
                if buf is None:
                    buf = self._buffers[key] = torch.empty(
                        shape, dtype=dtype, pin_memory=True)
                dist.recv(buf, int(src), tag=int(tag),
                          group=self._messages_group)
                t1 = time.perf_counter()
                out = buf.to(dev)
                torch.cuda.synchronize(dev)
                copy_s = time.perf_counter() - t1
        else:
            out = torch.empty(shape, dtype=dtype, device=dev)
            dist.recv(out, int(src), tag=int(tag),
                      group=self._messages_group)
        self._book(primitive, out.numel() * out.element_size(),
                   time.perf_counter() - t0, copy_s, call=call)
        return out

    def wait_sends(self) -> None:
        """Wait for every posted send; their pinned buffers go back to
        the pool. The wait is booked as the sends' wire time."""
        pending, self._pending = self._pending, []
        for work, buf, primitive, _ in pending:
            t0 = time.perf_counter()
            work.wait()
            self._book(primitive, 0, time.perf_counter() - t0, call=False)
            if buf is not None:
                self._send_pool.setdefault(
                    (tuple(buf.shape), buf.dtype), []).append(buf)

    def ordered_sum(self, tensor: torch.Tensor, ranks, tag: int):
        """`tensor` added over the processes `ranks` (this one among them)
        in rank order, on every one of them: each sends its part to the
        others and adds every part in the same order, so all hold the
        same bits (gloo's all_reduce may add in another order on each
        rank). One rank: `tensor` itself."""
        ranks = sorted(int(r) for r in ranks)
        if len(ranks) == 1:
            return tensor
        for r in ranks:
            if r != self.rank:
                self.send(tensor, r, tag, primitive="sum", call=False)
        parts = [tensor if r == self.rank else
                 self.recv(tensor.shape, tensor.dtype, tensor.device, r,
                           tag, primitive="sum", call=False)
                 for r in ranks]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        self.wait_sends()
        self._book("sum", 0, 0.0)          # one call
        return total


class MessageTags:
    """Tags of the point-to-point messages of one program over processes:
    a mixed-radix code of named coordinates, each below its size (one
    left out at 0, and one the tags lack must be 0), times two, so that
    a forward message's tag is even and its backward twin's (the
    cotangent going back) the next odd number. Sizes whose code does not
    fit below `SUM_TAGS` raise; ordered sums outside autograd take tags
    from `SUM_TAGS` up."""

    SUM_TAGS = 1 << 30

    def __init__(self, **sizes):
        self.fields = tuple(sizes)
        self.sizes = tuple(max(int(v), 1) for v in sizes.values())
        if 2 * math.prod(self.sizes) > self.SUM_TAGS:
            raise ValueError(
                f"{dict(zip(self.fields, self.sizes))} need "
                f"{2 * math.prod(self.sizes)} message tags, more than "
                f"{self.SUM_TAGS}")

    def __call__(self, **coords) -> int:
        code = 0
        for field, size in zip(self.fields, self.sizes):
            v = int(coords.pop(field, 0))
            if not 0 <= v < size:
                raise ValueError(f"tag coordinate {field}={v} outside "
                                 f"[0, {size})")
            code = code * size + v
        extra = {f: v for f, v in coords.items() if v != 0}
        if extra:   # a coordinate the tags lack must be 0 (a size-1 axis)
            raise ValueError(f"no tag coordinates {sorted(extra)}")
        return 2 * code


class Link:
    """The messages of one differentiable program over processes (a
    training step, one ring attention call): every send, receive and
    Megatron copy or sum across processes is an autograd node that takes
    the chain's token and hands on a new one, so a backward from `join`
    runs this process's message nodes in the reverse of their forward
    order. That backward is the transposed program: each forward send is
    a blocking receive of its cotangent and each forward receive a
    non-blocking send, and since the forward (non-blocking sends,
    blocking receives, every rank in its program order) cannot wait in a
    cycle, neither can its reverse. Messages carry `tags`' codes.

    The message nodes keep the exchange, never the link: the link holds
    the chain's last token, whose graph holds those nodes, and a cycle
    through autograd's graph would keep the step's graph (and the masters
    its leaves hold) alive after the step.

    A message sent again under a tag this link already used is a
    recompute (`torch.utils.checkpoint`): nothing is sent and the tensor
    received the first time comes back. Only the messages received inside
    `recomputable()`, the checkpointed regions, are kept for that, each
    until its recompute takes it, so a tensor that remat frees is not
    held here. `differentiable=False` (inputs that need no gradient)
    keeps the chain out of the outputs' graph."""

    def __init__(self, exchange: Exchange, tags: MessageTags, device,
                 differentiable: bool = True):
        self.exchange = exchange
        self.tags = tags
        self.token = torch.zeros((), device=device,
                                 requires_grad=bool(differentiable))
        self._seen: set = set()
        self._kept: dict = {}
        self._recording = False

    @contextlib.contextmanager
    def recomputable(self):
        """Messages received inside are a checkpointed region's: kept
        until its recompute replays them. The recompute runs the whole
        region (checkpoint's early stop off), so that it replays, and
        frees, every one: a message after the region's last saved tensor
        (Megatron's `g` at a sublayer's end) included."""
        outer, self._recording = self._recording, True
        try:
            with set_checkpoint_early_stop(False):
                yield
        finally:
            self._recording = outer

    def _keep(self, tag, tensor) -> None:
        if self._recording:
            self._kept[tag] = tensor

    def _replay(self, tags) -> bool:
        seen = [t in self._seen for t in tags]
        if any(seen) and not all(seen):
            raise RuntimeError(f"message tags {tags} half seen before")
        self._seen.update(tags)
        return bool(seen) and all(seen)

    def _cached(self, tag):
        if tag not in self._kept:
            raise RuntimeError(
                f"message {tag} replayed, but it was not received inside "
                f"Link.recomputable() (or was replayed before)")
        return self._kept.pop(tag).detach().requires_grad_(True)

    def _advance(self, out):
        *got, self.token = out
        return got

    def messages(self, sends=(), recvs=()) -> list:
        """Post `sends` [(tensor, dst, tag)] and take `recvs` [(shape,
        dtype, device, src, tag)]; returns the received tensors. In the
        backward the received tensors' cotangents go back to their
        senders and the sent tensors' cotangents come back."""
        tags = [t for *_, t in sends] + [t for *_, t in recvs]
        if self._replay(tags):
            return [self._cached(r[-1]) for r in recvs]
        return self._advance(_Messages.apply(
            self, tuple((int(d), int(t)) for _, d, t in sends),
            tuple(recvs), self.token, *[s[0] for s in sends]))

    def copy_out(self, y, local_devices, remote) -> list:
        """Megatron's `f` from the home position across processes: y's
        copies on `local_devices` [(j, device)] and y sent to each of
        `remote` [(j, dst, tag)]; backward the copies' cotangents and the
        remote positions' (received) are added in model-position order."""
        if self._replay([t for _, _, t in remote]):
            return [y.to(d, copy=True) for _, d in local_devices]
        return self._advance(_CopyOut.apply(
            self, tuple(local_devices), tuple(remote), self.token, y))

    def sum_in(self, parts, device) -> torch.Tensor:
        """Megatron's `g` on the home position across processes: `parts`
        in model-position order, each a local tensor or (src, tag, shape,
        dtype) of a remote position's part, added in that order on
        `device`; backward each part gets the sum's cotangent (the remote
        ones sent back)."""
        remote = [p for p in parts if not torch.is_tensor(p)]
        tags = [p[1] for p in remote]
        if self._replay(tags):
            got = [p if torch.is_tensor(p) else self._cached(p[1])
                   for p in parts]
            out = got[0].to(device)
            for p in got[1:]:
                out = out + p.to(device)
            return out
        order = tuple(None if torch.is_tensor(p) else tuple(p)
                      for p in parts)
        local = [p for p in parts if torch.is_tensor(p)]
        out, = self._advance(_SumIn.apply(self, order, torch.device(device),
                                          self.token, *local))
        return out

    def gather(self, pieces, owners, dim: int, device, tag,
               meta) -> torch.Tensor:
        """Every position's piece on every process, concatenated along
        `dim` in position order on `device`: pieces[i] is this process's
        tensor where it owns position i (owners[i]) and None elsewhere,
        each of (shape, dtype) `meta`; `tag(i)` is position i's message
        tag. Backward each local piece takes its rows of the cotangent
        (every process computed the same function of the whole, as a
        global array's holders do)."""
        out, self.token = _Gather.apply(
            self, tuple(owners), int(dim), torch.device(device), tag,
            tuple(meta), self.token, *pieces)
        return out

    def join(self, out: torch.Tensor) -> torch.Tensor:
        """`out` tied to the chain's last token, so that a backward from
        it runs every message node."""
        return _Join.apply(out, self.token)

    def finish(self) -> None:
        """The step's end: wait for every send (and drop what no
        recompute took)."""
        self.exchange.wait_sends()
        self._kept.clear()


def _zero_token(t):
    return torch.zeros((), device=t.device)


class _Messages(torch.autograd.Function):
    """Sends and receives as one node (`Link.messages`)."""

    @staticmethod
    def forward(ctx, link, sends, recvs, token, *sent):
        ex = link.exchange
        for t, (dst, tag) in zip(sent, sends):
            ex.send(t, dst, tag)
        got = [ex.recv(shape, dtype, dev, src, tag)
               for shape, dtype, dev, src, tag in recvs]
        for (*_, tag), g in zip(recvs, got):
            link._keep(tag, g)
        ctx.exchange, ctx.sends, ctx.recvs = ex, sends, recvs
        ctx.sent_meta = [(t.shape, t.dtype, t.device) for t in sent]
        return (*got, _zero_token(token))

    @staticmethod
    def backward(ctx, *grads):
        ex = ctx.exchange
        for g, (_, _, _, src, tag) in zip(grads[:-1], ctx.recvs):
            ex.send(g, src, tag + 1)
        back = [ex.recv(shape, dtype, dev, dst, tag + 1)
                for (dst, tag), (shape, dtype, dev) in zip(ctx.sends,
                                                           ctx.sent_meta)]
        return (None, None, None, _zero_token(grads[-1]), *back)


class _CopyOut(torch.autograd.Function):
    """The home side of Megatron's `f` across processes (`Link.copy_out`)."""

    @staticmethod
    def forward(ctx, link, local_devices, remote, token, y):
        for _, dst, tag in remote:
            link.exchange.send(y, dst, tag)
        ctx.exchange = link.exchange
        ctx.local_devices, ctx.remote = local_devices, remote
        ctx.meta = (y.shape, y.dtype, y.device)
        return (*[y.to(d, copy=True) for _, d in local_devices],
                _zero_token(token))

    @staticmethod
    def backward(ctx, *grads):
        shape, dtype, dev = ctx.meta
        parts = {j: g for (j, _), g in zip(ctx.local_devices, grads[:-1])}
        for j, dst, tag in ctx.remote:
            parts[j] = ctx.exchange.recv(shape, dtype, dev, dst, tag + 1)
        total = None
        for j in sorted(parts):
            g = parts[j].to(dev)
            total = g if total is None else total + g
        return (None, None, None, _zero_token(grads[-1]), total)


class _SumIn(torch.autograd.Function):
    """The home side of Megatron's `g` across processes (`Link.sum_in`)."""

    @staticmethod
    def forward(ctx, link, order, device, token, *local):
        ex, it, parts = link.exchange, iter(local), []
        for item in order:
            if item is None:
                parts.append(next(it).to(device))
            else:
                src, tag, shape, dtype = item
                got = ex.recv(shape, dtype, device, src, tag)
                link._keep(tag, got)
                parts.append(got)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        ctx.exchange, ctx.order = ex, order
        ctx.local_devices = [t.device for t in local]
        return out, _zero_token(token)

    @staticmethod
    def backward(ctx, g, g_token):
        for item in ctx.order:
            if item is not None:
                ctx.exchange.send(g, item[0], item[1] + 1)
        return (None, None, None, _zero_token(g_token),
                *[g.to(d) for d in ctx.local_devices])


class _Gather(torch.autograd.Function):
    """Every position's piece on every process (`Link.gather`)."""

    @staticmethod
    def forward(ctx, link, owners, dim, device, tag, meta, token, *pieces):
        ex = link.exchange
        mine = [i for i, o in enumerate(owners) if o == ex.rank]
        for i in mine:
            for r in range(ex.world):
                if r != ex.rank:
                    ex.send(pieces[i], r, tag(i))
        full = []
        for i, o in enumerate(owners):
            if o == ex.rank:
                full.append(pieces[i].to(device))
            else:
                full.append(ex.recv(meta[0], meta[1], device, o, tag(i)))
        ctx.mine, ctx.dim = mine, dim
        ctx.sizes = [t.shape[dim] for t in full]
        ctx.devices = {i: pieces[i].device for i in mine}
        ctx.n = len(pieces)
        return torch.cat(full, dim), _zero_token(token)

    @staticmethod
    def backward(ctx, g, g_token):
        grads = [None] * ctx.n
        parts = g.split(ctx.sizes, ctx.dim)
        for i in ctx.mine:
            grads[i] = parts[i].to(ctx.devices[i])
        return (None, None, None, None, None, None, _zero_token(g_token),
                *grads)


class _Join(torch.autograd.Function):
    """`out` as it is, with the token chain as a second input
    (`Link.join`)."""

    @staticmethod
    def forward(ctx, out, token):
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros((), device=g.device)


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
