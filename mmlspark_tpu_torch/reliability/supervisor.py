"""Fault-tolerant training supervision: async verified checkpoints,
preemption handling, deterministic crash-resume.

Port of the reference's `reliability/supervisor.py` (`:69-84`,
`:214-634`; it imports no JAX):

- `AsyncCheckpointWriter`: background checkpoint writes behind a bounded
  latest-wins queue. The GBDT estimators' periodic checkpoints go through
  it, so the boosting loop never waits on the disk.
- `TrainingSupervisor` wraps a step-function training loop
  (`ShardedLMTrainer.run_stream(checkpoint_dir=...)` uses it): resume from
  the newest digest-valid checkpoint; in-run restart of a failed step from
  the in-memory snapshot under a `RetryPolicy`; a per-step `step_timeout`
  (`StepTimeout`); SIGTERM/SIGINT write a final synchronous checkpoint,
  then raise `Preempted` (or exit 0 with `run(exit_on_preempt=True)`).
  The payload carries the reference's reserved keys (`sup_step`,
  `sup_results`, `sup_preempted`, `sup_clock`), so a directory that
  either package wrote resumes in the other. Fault sites `train.step<k>`,
  `train.ckpt.write` and `train.ckpt.read`.

Its multi-process arguments work as the reference's: a `heartbeat`
(`parallel.cluster.Heartbeat`) beats at every checkpoint mark with the
step clock's stats and clears on a clean finish; on each beat the
`straggler` detector (`telemetry.goodput.StragglerDetector`, made from
the heartbeat at `straggler_threshold` when not given) flags slow hosts,
whose pending chunks the `chunk_planner` (`data.ChunkPlanner`) drains,
and `host_leases` (`reliability.elastic.HostLeases`) declares silent
hosts dead, which the `elastic` plan (`ElasticPlan.shrink`) acts on (or,
without one, the planner's `remove_hosts`). None of these may kill the
training loop.

Telemetry as the reference's: a `train.step` span per step attempt
(covering its fault site), a `checkpoint.write` span per write attempt,
`train.resume` / `train.restart` / `train.preempted` events, and the
`train.step` region (`utils.tracing.annotate`) around each step function
call, on the thread that runs it: captured profiles attribute the step's
kernels to it and the roofline ledger gets a `train.step` row.
"""
from __future__ import annotations

import collections
import json
import logging
import signal as _signal
import threading
import time
from typing import TYPE_CHECKING, Callable, Optional, Sequence

import numpy as np

from ..telemetry.spans import get_tracer
from ..utils.tracing import annotate
from . import names as tnames
from .faults import FaultInjector, InjectedFault
from .metrics import reliability_metrics
from .policy import RetryPolicy

if TYPE_CHECKING:   # utils.checkpoint imports this package's metrics
    from ..utils.checkpoint import CheckpointManager

logger = logging.getLogger(__name__)

# Reserved payload keys the supervisor rides alongside the user's state.
STEP_KEY = "sup_step"
RESULTS_KEY = "sup_results"
PREEMPTED_KEY = "sup_preempted"
CLOCK_KEY = "sup_clock"          # StepClock accounting (goodput survives kill)
_RESERVED = (STEP_KEY, RESULTS_KEY, PREEMPTED_KEY, CLOCK_KEY)

class StepTimeout(RuntimeError):
    """A training step exceeded its wall-clock budget (`step_timeout`)."""


class Preempted(RuntimeError):
    """Raised by `TrainingSupervisor.run` after SIGTERM/SIGINT triggered the
    final synchronous checkpoint. The run is resumable from that checkpoint;
    catch this and `sys.exit(0)` so the scheduler sees a clean exit."""

    def __init__(self, step: int, signum: int):
        super().__init__(f"preempted by signal {signum} at step {step} "
                         f"(final checkpoint written)")
        self.step = step
        self.signum = signum


class AsyncCheckpointWriter:
    """Background checkpoint writer behind a bounded latest-wins queue.

    `submit()` NEVER blocks the calling (step) thread: when the queue is
    full the OLDEST pending snapshot is dropped (the newest state supersedes
    it — counted under `checkpoint.write.coalesced`) and the new one is
    enqueued. A failed async write is logged and counted
    (`checkpoint.write.errors`) but does not kill training — a torn write
    costs one checkpoint interval, exactly like a torn disk would.
    `write_sync()` drains the queue then writes on the caller's thread (the
    final/preemption checkpoint, which MUST be durable before exit).
    `faults`: an injector fired at "train.ckpt.write" before each write
    (tests only; None injects nothing).
    """

    def __init__(self, manager: "CheckpointManager", depth: int = 2,
                 metrics=None, faults: Optional[FaultInjector] = None):
        self.manager = manager
        self.depth = max(int(depth), 1)
        self.metrics = metrics if metrics is not None else reliability_metrics
        self.faults = faults      # None: no fault injection
        self._q: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._busy = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # -- producer side (step thread) -----------------------------------------
    def submit(self, step: int, payload: dict,
               prune_newer: bool = False) -> None:
        t0 = time.perf_counter()
        with self._cond:
            if self._closed:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            while len(self._q) >= self.depth:
                self._q.popleft()
                self.metrics.inc(tnames.CHECKPOINT_WRITE_COALESCED)
            self._q.append((int(step), payload, bool(prune_newer)))
            self.metrics.set_gauge(tnames.CHECKPOINT_WRITE_PENDING, len(self._q))
            if self._thread is None:
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True,
                                                name="ckpt-writer")
                self._thread.start()
            self._cond.notify_all()
        self.metrics.observe_ms(tnames.CHECKPOINT_SUBMIT,
                                (time.perf_counter() - t0) * 1000.0)

    def pending(self) -> int:
        with self._cond:
            return len(self._q) + (1 if self._busy else 0)

    def flush(self, timeout: float = 30.0) -> None:
        """Block until every submitted snapshot has been written."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._q or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"checkpoint writer did not drain within {timeout}s "
                        f"({len(self._q)} pending)")
                self._cond.wait(remaining)

    def write_sync(self, step: int, payload: dict,
                   prune_newer: bool = False,
                   flush_timeout: float = 30.0) -> None:
        """Drain pending async writes, then write THIS snapshot on the
        caller's thread — the final checkpoint must be on disk when this
        returns, so errors propagate instead of being absorbed."""
        self.flush(timeout=flush_timeout)
        self._write(int(step), payload, bool(prune_newer), absorb=False)

    def close(self, flush: bool = True) -> None:
        if flush:
            try:
                self.flush()
            except TimeoutError:
                logger.warning("checkpoint writer close(): flush timed out")
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- writer thread --------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._closed:
                    self._cond.wait()
                if not self._q and self._closed:
                    return
                step, payload, prune = self._q.popleft()
                self._busy = True
                self.metrics.set_gauge(tnames.CHECKPOINT_WRITE_PENDING,
                                       len(self._q))
            try:
                self._write(step, payload, prune, absorb=True)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _write(self, step: int, payload: dict, prune_newer: bool,
               absorb: bool) -> None:
        t0 = time.perf_counter()
        # lifecycle span (sync finals and async writer-thread writes
        # alike): every write attempt with its outcome
        span = get_tracer().start_span(
            tnames.CHECKPOINT_WRITE_SPAN,
            attrs={"step": step, "sync": not absorb})
        try:
            if self.faults is not None:
                self.faults.perturb("train.ckpt.write")
            self.manager.save(step, payload, prune_newer=prune_newer)
            if span is not None:
                span.finish(ok=True)
        except Exception as e:  # noqa: BLE001 - async writes must not kill training
            if span is not None:
                span.finish(ok=False, error=type(e).__name__)
            self.metrics.inc(tnames.CHECKPOINT_WRITE_ERRORS)
            logger.warning("checkpoint write for step %d failed (%s: %s)",
                           step, type(e).__name__, e)
            if not absorb:
                raise
        finally:
            self.metrics.observe_ms(tnames.CHECKPOINT_WRITE,
                                    (time.perf_counter() - t0) * 1000.0)


class TrainingSupervisor:
    """Wrap a step-function training loop with checkpoint/resume, restart,
    and preemption handling.

        sup = TrainingSupervisor(ckpt_dir, snapshot_fn, restore_fn,
                                 checkpoint_every=10)
        losses = sup.run(step_fn, n_steps)   # resumes, restarts, finalizes

    - `snapshot_fn() -> dict`: the training state as a CheckpointManager
      payload (numpy arrays + JSON scalars), taken on the step thread; the
      disk write happens on the writer thread.
    - `restore_fn(payload) -> None`: apply a payload back onto live state.
    - `step_fn(step) -> result`: one training step; results are collected
      (and checkpointed, so a resumed run returns the full history).
    - `seek(step)` (optional, per `run`): position the data stream at
      `step`, once after resume and again after every crash rewind.

    Restart policy: exceptions in `restart_on` (by default injected faults
    and step timeouts) restore the last in-memory snapshot and replay from
    its step; `retry_policy` bounds the restarts of a run. Anything else
    propagates, and the checkpoints on disk make the next process's
    `run()` resume. `faults=None` injects nothing. The multi-process
    arguments are the module docstring's.
    """

    def __init__(self, directory: str,
                 snapshot_fn: Callable[[], dict],
                 restore_fn: Callable[[dict], None], *,
                 checkpoint_every: int = 1, max_to_keep: int = 3,
                 queue_depth: int = 2,
                 step_timeout: Optional[float] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 restart_on: Sequence[type] = (InjectedFault, StepTimeout),
                 handle_signals: bool = True,
                 heartbeat=None, manager: Optional["CheckpointManager"] = None,
                 metrics=None, faults: Optional[FaultInjector] = None,
                 step_clock=None, straggler=None,
                 straggler_threshold: float = 1.5,
                 chunk_planner=None, host_leases=None, elastic=None):
        # lazy imports: utils.checkpoint imports this package's metrics,
        # and telemetry.goodput imports this package's names
        from ..telemetry.goodput import StepClock, StragglerDetector
        from ..utils.checkpoint import CheckpointManager
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.checkpoint_every = max(int(checkpoint_every), 0)  # 0 = final only
        self.step_timeout = step_timeout
        self.restart_on = tuple(restart_on)
        self.handle_signals = handle_signals
        self.metrics = metrics if metrics is not None else reliability_metrics
        self.faults = faults      # None: no fault injection
        self.manager = manager if manager is not None else CheckpointManager(
            directory, max_to_keep=max_to_keep)
        self.retry_policy = retry_policy if retry_policy is not None else \
            RetryPolicy(max_attempts=3, backoff=0.05, max_backoff=1.0,
                        metric_name=tnames.TRAIN_STEP_RETRIES)
        self.writer = AsyncCheckpointWriter(self.manager, depth=queue_depth,
                                            metrics=self.metrics,
                                            faults=self.faults)
        # the clock rides every step; its state rides the checkpoint
        # payload so a killed-and-resumed run keeps cumulative goodput
        self.clock = (step_clock if step_clock is not None
                      else StepClock(registry=self.metrics))
        self.heartbeat = heartbeat
        if straggler is None and heartbeat is not None:
            # processes exchange their step p50s through the heartbeat
            # files; every process runs the same check on its beat
            straggler = StragglerDetector(heartbeat,
                                          threshold=straggler_threshold,
                                          registry=self.metrics)
        self.straggler = straggler or None
        self.chunk_planner = chunk_planner
        self.host_leases = host_leases
        self.elastic = elastic
        self.resumed_step: Optional[int] = None
        self._resumed_results: list = []
        self._last: Optional[tuple] = None   # (step, payload, results) rewind
        self._preempt: Optional[int] = None
        self._att_gen = None
        self._att = None
        self._results_numeric = True    # losses ride the binary payload
        self._results_jsonable = True   # flips once a non-JSON result shows
        self._results_probed = 0        # results proven serializable so far

    # -- resume ---------------------------------------------------------------
    def resume(self) -> int:
        """Restore the newest digest-valid checkpoint (if any) through
        `restore_fn` and return the step to continue from (0 = fresh run).
        Fires the `train.ckpt.read` fault site."""
        if self.faults is not None:
            self.faults.perturb("train.ckpt.read")
        if self.manager.latest_step() is None:
            return 0
        payload, loaded = self.manager.restore(with_step=True)
        # the step ACTUALLY loaded (a corrupt-newest fallback makes it
        # differ from latest_step())
        step = int(payload.get(STEP_KEY, loaded))
        clock_state = payload.get(CLOCK_KEY)
        if clock_state is not None:
            self.clock.restore_state(clock_state)
        hist = payload.get(RESULTS_KEY, ())
        if isinstance(hist, np.ndarray):   # numeric history rode the npz
            hist = [float(v) for v in hist]
        self._resumed_results = list(hist if hist is not None else ())
        self.restore_fn({k: v for k, v in payload.items()
                         if k not in _RESERVED})
        self.resumed_step = step
        self.metrics.inc(tnames.TRAIN_RESUMES)
        self.metrics.set_gauge(tnames.TRAIN_RESUME_STEP, step)
        get_tracer().event(tnames.TRAIN_RESUME_EVENT, step=step)
        logger.info("resumed training from checkpoint step %d", step)
        return step

    # -- the loop -------------------------------------------------------------
    def run(self, step_fn: Callable[[int], object], n_steps: int, *,
            seek: Optional[Callable[[int], None]] = None,
            resume: bool = True, exit_on_preempt: bool = False) -> list:
        """Train steps [resume point, n_steps); returns every step's
        result. On SIGTERM/SIGINT the final checkpoint is written, then
        `Preempted` is raised, or `SystemExit(0)` with
        `exit_on_preempt`."""
        start = self.resume() if resume else 0
        results = list(self._resumed_results)
        del results[start:]   # history beyond the restored step is stale
        if start >= n_steps:
            logger.warning(
                "resumed checkpoint step %d >= n_steps %d; returning the "
                "restored history without training", start, n_steps)
            return results
        step = start
        self._mark(step, results, write=False)   # in-memory rewind baseline
        if seek is not None:
            seek(step)
        old_handlers = self._install_signals()
        try:
            while step < n_steps:
                if self._preempt is not None:
                    self._preempted(step, results, exit_on_preempt)
                try:
                    # the step span covers the fault site too, so an
                    # injected failure records error=<type> on ITS step;
                    # the clock wraps both: a failed attempt's wall books
                    # as lost
                    with self.clock.step(step), \
                            get_tracer().span(tnames.TRAIN_STEP_SPAN,
                                              step=step):
                        if self.faults is not None:
                            t_fault = time.perf_counter()
                            fault = self.faults.perturb(f"train.step{step}")
                            if fault is not None and fault.kind == "delay":
                                # an injected stall: wall that produced
                                # no state
                                self.clock.note(
                                    "lost", time.perf_counter() - t_fault)
                        out = self._call_step(step_fn, step)
                except self.restart_on as e:
                    step, results = self._restart(e, seek)
                    continue
                results.append(out)
                step += 1
                if (self.checkpoint_every and step < n_steps
                        and step % self.checkpoint_every == 0):
                    self._mark(step, results, write=True)
            if self._preempt is not None:
                # the signal landed DURING the last step: the scheduler
                # expects the process to exit
                self._preempted(step, results, exit_on_preempt)
            self._finalize(n_steps, results, preempted=False)
            return results
        finally:
            self._restore_signals(old_handlers)

    def close(self) -> None:
        self.writer.close(flush=True)

    @property
    def preempted(self) -> bool:
        """Did a SIGTERM/SIGINT arrive during `run`?"""
        return self._preempt is not None

    # -- internals ------------------------------------------------------------
    def _preempted(self, step: int, results: list, exit_on_preempt: bool):
        self._finalize(step, results, preempted=True)
        if exit_on_preempt:
            raise SystemExit(0)
        raise Preempted(step, self._preempt)

    def _call_step(self, step_fn, step: int):
        if self.step_timeout is None:
            with annotate("train.step"):
                return step_fn(step)
        box: dict = {}

        def target():
            try:
                with annotate("train.step"):
                    box["out"] = step_fn(step)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                box["err"] = e

        t = threading.Thread(target=target, daemon=True,
                             name=f"train-step-{step}")
        t.start()
        t.join(self.step_timeout)
        if t.is_alive():
            # the stuck step thread is abandoned (daemon) and the retried
            # step runs fresh: the watchdog suits steps that hang in host
            # I/O, not steps that may later complete and race the replay
            self.metrics.inc(tnames.TRAIN_STEP_TIMEOUTS)
            raise StepTimeout(
                f"step {step} exceeded its {self.step_timeout}s budget")
        if "err" in box:
            raise box["err"]
        return box.get("out")

    def _restart(self, err: BaseException, seek) -> tuple:
        if self._att_gen is None:
            self._att_gen = self.retry_policy.attempts()
            self._att = next(self._att_gen)
        if self._att.is_last:
            raise err
        self._att.retry()
        self._att = next(self._att_gen, None)
        if self._att is None:
            raise err
        assert self._last is not None
        last_step, payload, results = self._last
        # everything since that snapshot re-executes: its wall is lost
        self.clock.rewound()
        self.metrics.inc(tnames.TRAIN_STEP_RESTARTS)
        get_tracer().event(tnames.TRAIN_RESTART_EVENT, step=last_step,
                           error=type(err).__name__)
        logger.warning("training step failed (%s: %s); restarting from "
                       "snapshot step %d", type(err).__name__, err, last_step)
        self.restore_fn({k: v for k, v in payload.items()
                         if k not in _RESERVED})
        if seek is not None:
            seek(last_step)
        # rewind from the IN-MEMORY history: non-JSON results never ride
        # the payload, and an in-process restart must not discard them
        return last_step, list(results)

    def _snapshot(self, step: int, results: list) -> dict:
        t0 = time.perf_counter()
        payload = dict(self.snapshot_fn())
        for k in _RESERVED:
            payload.pop(k, None)
        payload[STEP_KEY] = int(step)
        payload[CLOCK_KEY] = np.asarray(self.clock.state_vector(),
                                        np.float64)
        if self._results_numeric and all(
                isinstance(r, (int, float, np.floating, np.integer))
                for r in results[self._results_probed:]):
            # per-step losses: the history rides the binary payload
            self._results_probed = len(results)
            payload[RESULTS_KEY] = np.asarray(results, np.float64)
        else:
            self._results_numeric = False
            if self._results_jsonable:
                try:
                    json.dumps(results[self._results_probed:])
                    self._results_probed = len(results)
                    payload[RESULTS_KEY] = list(results)
                except (TypeError, ValueError):
                    # non-JSON results: resumable, but history restarts
                    self._results_jsonable = False
        self.metrics.observe_ms(tnames.CHECKPOINT_SNAPSHOT,
                                (time.perf_counter() - t0) * 1000.0)
        return payload

    def _beat(self, step: Optional[int]) -> None:
        """Heartbeat write (or clear, step=None), then the straggler and
        liveness checks and their actuation. A lost beat (an injected
        fault, a full disk) is counted and logged, and a failed
        actuation logged: none of it may kill a healthy training loop."""
        if self.heartbeat is None:
            return
        try:
            if step is None:
                self.heartbeat.clear()
            else:
                # the beat carries this process's windowed step p50, so
                # every peer's straggler check sees it
                self.heartbeat.beat(step, stats=self.clock.beat_stats())
        except Exception as e:  # noqa: BLE001 - observability must not kill
            self.metrics.inc(tnames.CLUSTER_HEARTBEAT_ERRORS)
            logger.warning("heartbeat update failed (%s: %s)",
                           type(e).__name__, e)
        if step is not None and self.straggler is not None:
            flagged = self.straggler.check()   # never raises
            if flagged and self.chunk_planner is not None:
                # drain the flagged hosts' pending chunks; on a failure
                # the straggler keeps its chunks
                try:
                    self.chunk_planner.reassign(flagged)
                except Exception as e:  # noqa: BLE001
                    logger.warning("chunk reassignment failed (%s: %s)",
                                   type(e).__name__, e)
        # getattr: tests drive _beat on supervisors made with __new__
        leases = getattr(self, "host_leases", None)
        if step is not None and leases is not None:
            dead = leases.check()              # never raises
            if dead:
                # shrink over the survivors, or at least drain the dead
                # hosts' chunks
                try:
                    elastic = getattr(self, "elastic", None)
                    if elastic is not None:
                        elastic.shrink(dead)
                    elif self.chunk_planner is not None:
                        self.chunk_planner.remove_hosts(dead)
                except Exception as e:  # noqa: BLE001
                    logger.warning("elastic shrink failed (%s: %s)",
                                   type(e).__name__, e)

    def _mark(self, step: int, results: list, write: bool) -> None:
        t0 = time.perf_counter()
        payload = self._snapshot(step, results)
        self._last = (step, payload, list(results))
        if write:
            self.writer.submit(step, payload)
        # snapshot+submit is the checkpoint stall the step thread pays; a
        # durable mark also resets the rewindable-wall window
        self.clock.note("checkpoint", time.perf_counter() - t0)
        self.clock.marked()
        self._beat(step)

    def _finalize(self, step: int, results: list, preempted: bool) -> None:
        t0 = time.perf_counter()
        payload = self._snapshot(step, results)
        payload[PREEMPTED_KEY] = bool(preempted)
        try:
            self.writer.write_sync(step, payload)
        except Exception as e:  # noqa: BLE001 - see preempt contract below
            if not preempted:
                raise   # a clean finish must not hide a lost final write
            # preemption: the clean-exit contract outranks the final
            # write; best effort, try the direct write, else the periodic
            # checkpoints still allow resume
            self.metrics.inc(tnames.CHECKPOINT_FINALIZE_ERRORS)
            logger.warning("final preemption checkpoint write failed "
                           "(%s: %s); resuming will use the last periodic "
                           "checkpoint", type(e).__name__, e)
            try:
                self.manager.save(step, payload)
            except Exception:  # noqa: BLE001
                pass
        self.clock.note("checkpoint", time.perf_counter() - t0)
        self.clock.publish()
        if preempted:
            self.metrics.inc(tnames.TRAIN_PREEMPTED)
            get_tracer().event(tnames.TRAIN_PREEMPTED_EVENT, step=step,
                               signum=self._preempt)
            self._beat(step)
        else:
            self._beat(None)   # clean finish: the next start is fresh

    # -- signals --------------------------------------------------------------
    def _install_signals(self):
        if not self.handle_signals:
            return None

        def handler(signum, frame):
            self._preempt = signum
            self.metrics.inc(tnames.TRAIN_PREEMPT_SIGNALS)

        old = {}
        for sig in (_signal.SIGTERM, _signal.SIGINT):
            try:
                old[sig] = _signal.signal(sig, handler)
            except ValueError:   # not the main thread: poll-only preemption
                break
        return old

    def _restore_signals(self, old) -> None:
        if not old:
            return
        for sig, prev in old.items():
            try:
                _signal.signal(sig, prev)
            except ValueError:
                pass
