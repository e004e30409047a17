"""Multi-worker host transform pool with deterministic reassembly.

Port of the reference's `data/pool.py` (which imports no JAX): per-chunk
transforms (quantile binning, featurize stages) run on a pool of workers —
OS processes talking through POSIX shared-memory buffers (no pickling of
row data; `spawn`, since fork is unsafe once CUDA is initialised), or
threads for transforms that release the GIL (numpy column kernels do) or
refuse to pickle. Output is written by row range into one preallocated
buffer, so the result is bit-identical to the sequential path no matter
how many workers run or in what order chunks finish.

Crash semantics: a worker exception is captured with its chunk index and
re-raised in the caller as `WorkerCrashError` (first failing chunk wins,
deterministically — not first-to-fail in wall time). A worker process that
DIES (signal, hard exit) is detected by exitcode and reported the same way.
Failures count under `data.worker_failures`; the `FaultInjector` site
`data.worker.chunk<i>` is fired before each chunk's transform, so chaos
tests can kill exactly chunk i regardless of schedule. A pool built with
`faults=None` injects nothing (the port reads no injector from the
environment).
"""
from __future__ import annotations

import multiprocessing as _mp
import os
import pickle
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from ..reliability import names as tnames
from ..reliability.faults import FaultInjector
from ..reliability.metrics import reliability_metrics
from ..utils import tracing
from .chunk import Chunk, default_chunk_rows, make_chunks

# Below this many input bytes a process pool cannot win: spawn + two shm
# round-trips cost more than the transform. Threads (or inline) take over.
_PROCESS_MIN_BYTES = 64 << 20


class WorkerCrashError(RuntimeError):
    """A pool worker failed; carries the first failing chunk's index."""

    def __init__(self, chunk_index: int, message: str):
        super().__init__(f"ingest worker failed on chunk {chunk_index}: "
                         f"{message}")
        self.chunk_index = chunk_index


def _resolve_workers(num_workers: int) -> int:
    if num_workers and num_workers > 0:
        return int(num_workers)
    return max(os.cpu_count() or 1, 1)


def _fire_chunk_faults(faults: Optional[FaultInjector], index: int) -> None:
    """Chunk-indexed injection site: per-site call counters make `at: [0]`
    on site `data.worker.chunk<i>` fire exactly once for chunk i, giving
    seed-reproducible schedules even when processes race."""
    if faults is not None:
        faults.perturb(f"data.worker.chunk{index}")


def _run_chunk(fn: Callable, x: np.ndarray, out: np.ndarray, chunk: Chunk,
               faults: Optional[FaultInjector]) -> None:
    _fire_chunk_faults(faults, chunk.index)
    res = fn(x[chunk.lo:chunk.hi])
    res = np.asarray(res)
    if res.shape[0] != chunk.n_rows:
        raise ValueError(
            f"chunk transform returned {res.shape[0]} rows for a "
            f"{chunk.n_rows}-row chunk — row-aligned transforms only")
    out[chunk.lo:chunk.hi] = res


def _process_worker(fn_bytes: bytes, in_name: str, in_shape, in_dtype: str,
                    out_name: str, out_shape, out_dtype: str,
                    chunks, result_q, fault_spec, prog_name) -> None:
    """Child entry: attach both shared-memory buffers, run this worker's
    chunk set, write results in place. EVERY chunk reports a
    (chunk_index, traceback-or-None) marker — the parent requires a marker
    per chunk, so a lost/unreported chunk can never pass off uninitialized
    output as success. Completed chunks ALSO flip a per-chunk byte in the
    `prog_name` shared-memory progress buffer: the queue marker rides a
    feeder thread a SIGKILL can race, while the memory write is immediate —
    so a worker killed by signal mid-chunk is blamed for the chunk it was
    actually in, deterministically, not for whichever earlier markers the
    dying feeder failed to flush. Errors travel as formatted tracebacks,
    never raw exception objects (whose pickling can itself fail).
    `fault_spec` is the parent pool's injector as (seed, rules), or None
    for no injection — a passed FaultInjector keeps firing in process mode
    (per-site streams are seed-derived, so the child's schedule is the same
    one the parent would have fired)."""
    from multiprocessing import shared_memory
    shm_in = shm_out = shm_prog = None
    try:
        fn = pickle.loads(fn_bytes)
        faults = (FaultInjector(seed=fault_spec[0], rules=fault_spec[1])
                  if fault_spec is not None else None)
        shm_in = shared_memory.SharedMemory(name=in_name)
        shm_out = shared_memory.SharedMemory(name=out_name)
        shm_prog = shared_memory.SharedMemory(name=prog_name)
        x = np.ndarray(in_shape, dtype=np.dtype(in_dtype), buffer=shm_in.buf)
        out = np.ndarray(out_shape, dtype=np.dtype(out_dtype),
                         buffer=shm_out.buf)
        for index, lo, hi in chunks:
            try:
                _run_chunk(fn, x, out, Chunk(index, lo, hi), faults)
                shm_prog.buf[index] = 1   # durable before the queue marker
                result_q.put((index, None))
            except BaseException:  # noqa: BLE001 - report, keep going
                result_q.put((index, traceback.format_exc(limit=8)))
    except BaseException:  # noqa: BLE001 - setup failure: blame chunk -1
        result_q.put((-1, traceback.format_exc(limit=8)))
    finally:
        for shm in (shm_in, shm_out, shm_prog):
            if shm is not None:
                try:
                    shm.close()
                except OSError:
                    pass


class WorkerPool:
    """Order-preserving per-chunk map over row-major host data.

    mode:
      - "process": spawn workers + shared-memory input/output buffers
        (true parallelism for GIL-bound transforms; `fn` must pickle).
      - "thread": ThreadPoolExecutor (numpy kernels release the GIL, so
        binning/featurize still scale; zero-copy, any callable).
      - "auto": processes for large picklable work, threads otherwise.
    num_workers 0 = all cores; 1 = sequential in the calling thread (the
    degenerate pool — still chunked, still fault-injected, so `num_workers=1`
    vs `=4` differ only in schedule, never in output). `faults=None`
    injects nothing.
    """

    def __init__(self, num_workers: int = 0, mode: str = "auto",
                 faults: Optional[FaultInjector] = None, metrics=None):
        if mode not in ("auto", "process", "thread"):
            raise ValueError("mode must be auto|process|thread")
        self.num_workers = _resolve_workers(num_workers)
        self.mode = mode
        self.faults = faults      # None: no fault injection
        self.metrics = metrics if metrics is not None else reliability_metrics

    # -- mode selection ------------------------------------------------------
    def _pick_mode(self, fn: Callable, nbytes: int) -> str:
        if self.mode != "auto":
            return self.mode
        if self.num_workers <= 1 or nbytes < _PROCESS_MIN_BYTES:
            return "thread"
        try:
            pickle.dumps(fn)
        except Exception:  # noqa: BLE001 - unpicklable: threads handle it
            return "thread"
        return "process"

    # -- bulk map ------------------------------------------------------------
    def map_rows(self, fn: Callable[[np.ndarray], np.ndarray], x: np.ndarray,
                 out_width: int, out_dtype=np.float32,
                 chunk_rows: int = 0) -> np.ndarray:
        """Apply a row-aligned transform chunkwise; returns the (n, out_width)
        result, bit-identical to `fn(x)` for any row-independent fn."""
        x = np.asarray(x)
        n = x.shape[0]
        chunk_rows = chunk_rows or default_chunk_rows(
            n, int(np.prod(x.shape[1:])) or 1, self.num_workers,
            x.dtype.itemsize)
        chunks = make_chunks(n, chunk_rows)
        out_shape = (n, out_width) if out_width else (n,)
        out = np.empty(out_shape, dtype=out_dtype)
        mode = self._pick_mode(fn, x.nbytes)
        self.metrics.inc(tnames.data_pool_maps(mode))
        with tracing.wall_clock(tnames.data_pool_map_timing(mode),
                                sink=self.metrics.observe):
            if mode == "process" and len(chunks) > 1:
                self._map_process(fn, x, out, chunks)
            else:
                self._map_thread(fn, x, out, chunks)
        return out

    def run_chunks(self, chunks, work: Callable[[Chunk], None]) -> None:
        """Thread fan-out of `work` over chunks with the pool's crash
        semantics: errors collected per chunk, FIRST FAILING CHUNK INDEX
        (not first-to-fail in wall time) raised as WorkerCrashError, counted
        under data.worker_failures. Sequential (num_workers<=1) stops at the
        first error; threaded runs every chunk (in-flight work can't be
        recalled) and then reports. Shared by map_rows' thread backend and
        pipeline.ParallelTransform — one implementation of the contract."""
        errors: dict = {}

        def run(chunk: Chunk):
            try:
                work(chunk)
            except BaseException as e:  # noqa: BLE001
                errors[chunk.index] = e

        if self.num_workers <= 1 or len(chunks) <= 1:
            for c in chunks:
                run(c)
                if errors:
                    break
        else:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                list(pool.map(run, chunks))
        if errors:
            index = min(errors)
            self.metrics.inc(tnames.DATA_WORKER_FAILURES, len(errors))
            raise WorkerCrashError(index, repr(errors[index])) \
                from errors[index]

    def _map_thread(self, fn, x, out, chunks) -> None:
        self.run_chunks(chunks,
                        lambda c: _run_chunk(fn, x, out, c, self.faults))

    def _map_process(self, fn, x, out, chunks) -> None:
        import queue as _queue
        from multiprocessing import shared_memory
        ctx = _mp.get_context("spawn")   # fork after CUDA init is unsafe
        x = np.ascontiguousarray(x)
        shm_in = shared_memory.SharedMemory(create=True, size=max(x.nbytes, 1))
        shm_out = shared_memory.SharedMemory(create=True,
                                             size=max(out.nbytes, 1))
        # one completion byte per chunk, written by workers the instant a
        # chunk's output rows land — survives a SIGKILL that would eat the
        # queue feeder's unflushed markers (see _process_worker)
        shm_prog = shared_memory.SharedMemory(create=True, size=len(chunks))
        shm_prog.buf[:len(chunks)] = bytes(len(chunks))
        procs = []
        try:
            np.ndarray(x.shape, x.dtype, buffer=shm_in.buf)[...] = x
            shared_out = np.ndarray(out.shape, out.dtype, buffer=shm_out.buf)
            result_q = ctx.Queue()
            fn_bytes = pickle.dumps(fn)
            fault_spec = (None if self.faults is None
                          else (self.faults.seed, self.faults.rules))
            nw = min(self.num_workers, len(chunks))
            # static strided assignment: deterministic, balanced, no queue
            plans = [[(c.index, c.lo, c.hi) for c in chunks[w::nw]]
                     for w in range(nw)]
            for plan in plans:
                p = ctx.Process(
                    target=_process_worker,
                    args=(fn_bytes, shm_in.name, x.shape, x.dtype.str,
                          shm_out.name, out.shape, out.dtype.str, plan,
                          result_q, fault_spec, shm_prog.name),
                    daemon=True)
                p.start()
                procs.append(p)
            # drain WHILE the children run: a child cannot exit until its
            # queue feeder thread flushes to the pipe, so join-then-drain
            # deadlocks once many tracebacks fill the pipe buffer. Every
            # chunk owes a (index, tb-or-None) marker; success is declared
            # only when all markers arrived — a lost marker surfaces as a
            # crash, never as uninitialized rows passed off as output.
            done: dict = {}
            errors: dict = {}
            while len(done) < len(chunks):
                try:
                    index, tb = result_q.get(timeout=0.1)
                    if index < 0:
                        errors[index] = tb
                        break
                    done[index] = True
                    if tb is not None:
                        errors[index] = tb
                except _queue.Empty:
                    if all(p.exitcode is not None for p in procs):
                        # children gone; one grace drain, then account
                        try:
                            while True:
                                index, tb = result_q.get(timeout=0.2)
                                done[index] = True
                                if tb is not None:
                                    errors[index] = tb
                        except _queue.Empty:
                            pass
                        break
            # keep draining while joining: children can't exit until their
            # queue feeder flushes, so a bare join here could still wedge
            # behind markers we stopped reading (e.g. after a setup error)
            while any(p.is_alive() for p in procs):
                try:
                    index, tb = result_q.get(timeout=0.1)
                    done[index] = True
                    if tb is not None:
                        errors.setdefault(index, tb)
                except _queue.Empty:
                    pass
            for p in procs:
                p.join()
            dead = [p for p in procs if p.exitcode not in (0, None)]
            if len(done) < len(chunks) and not errors:
                missing = sorted(set(c.index for c in chunks) - set(done))
                # credit chunks whose shared-memory completion byte landed
                # even though the dying feeder ate their queue marker: the
                # output rows ARE in the buffer, and the FIRST chunk the
                # killed worker never completed becomes the deterministic
                # blame index (mid-chunk signal kills included)
                missing = [i for i in missing if shm_prog.buf[i] == 0]
                if missing:
                    code = dead[0].exitcode if dead else "unknown"
                    errors[missing[0]] = (f"worker process died (exitcode "
                                          f"{code}) before reporting chunks "
                                          f"{missing}")
            if errors:
                index = min(errors)
                self.metrics.inc(tnames.DATA_WORKER_FAILURES, len(errors))
                raise WorkerCrashError(index, str(errors[index]))
            out[...] = shared_out
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for shm in (shm_in, shm_out, shm_prog):
                try:
                    shm.close()
                    shm.unlink()
                except OSError:
                    pass

    # -- streaming map (for the overlapped device feed) ----------------------
    def imap_rows(self, fn: Callable[[np.ndarray], np.ndarray],
                  x: np.ndarray, chunk_rows: int = 0
                  ) -> Iterator[Tuple[Chunk, np.ndarray]]:
        """Lazily yield (chunk, transformed rows) IN CHUNK ORDER while later
        chunks are still being transformed — the producer side of the
        host->device prefetch overlap. Thread-backed regardless of mode
        (streaming wants results as they land, which shared-memory batch
        workers can't give without a second IPC layer); numpy transforms
        release the GIL, so this still uses every core."""
        x = np.asarray(x)
        n = x.shape[0]
        chunk_rows = chunk_rows or default_chunk_rows(
            n, int(np.prod(x.shape[1:])) or 1, self.num_workers,
            x.dtype.itemsize)
        chunks = make_chunks(n, chunk_rows)

        def one(chunk: Chunk):
            _fire_chunk_faults(self.faults, chunk.index)
            with tracing.wall_clock(tnames.DATA_BIN_CHUNK,
                                    sink=self.metrics.observe):
                res = np.asarray(fn(x[chunk.lo:chunk.hi]))
            if res.shape[0] != chunk.n_rows:
                raise ValueError(
                    f"chunk transform returned {res.shape[0]} rows for a "
                    f"{chunk.n_rows}-row chunk")
            return chunk, res

        if self.num_workers <= 1 or len(chunks) == 1:
            for c in chunks:
                yield self._wrap_crash(one, c)
            return
        from ..utils.async_utils import bounded_map
        # bounded ordered window: at most num_workers+2 chunks in flight,
        # so a slow consumer backpressures the transform instead of the
        # whole binned matrix piling up in RAM
        it = bounded_map(lambda c: self._wrap_crash(one, c), chunks,
                         concurrency=self.num_workers + 2)
        yield from it

    def _wrap_crash(self, one, chunk):
        try:
            return one(chunk)
        except WorkerCrashError:
            raise
        except BaseException as e:  # noqa: BLE001
            self.metrics.inc(tnames.DATA_WORKER_FAILURES)
            raise WorkerCrashError(chunk.index, repr(e)) from e
