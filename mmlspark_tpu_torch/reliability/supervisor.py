"""Background checkpoint writes for the port's training loops.

Port of `AsyncCheckpointWriter` from the reference's
`reliability/supervisor.py`: the GBDT estimators' periodic checkpoints go
through it, so the boosting loop never waits on the disk. The reference's
`TrainingSupervisor` (restarts, preemption, the LM `run_stream` loop) is
ROADMAP Queue 1 item 17; its write span is telemetry (item 23).
"""
from __future__ import annotations

import collections
import logging
import threading
import time
from typing import TYPE_CHECKING, Optional

from . import names as tnames
from .faults import FaultInjector
from .metrics import reliability_metrics

if TYPE_CHECKING:   # utils.checkpoint imports this package's metrics
    from ..utils.checkpoint import CheckpointManager

logger = logging.getLogger(__name__)


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
        try:
            if self.faults is not None:
                self.faults.perturb("train.ckpt.write")
            self.manager.save(step, payload, prune_newer=prune_newer)
        except Exception as e:  # noqa: BLE001 - async writes must not kill training
            self.metrics.inc(tnames.CHECKPOINT_WRITE_ERRORS)
            logger.warning("checkpoint write for step %d failed (%s: %s)",
                           step, type(e).__name__, e)
            if not absorb:
                raise
        finally:
            self.metrics.observe_ms(tnames.CHECKPOINT_WRITE,
                                    (time.perf_counter() - t0) * 1000.0)
