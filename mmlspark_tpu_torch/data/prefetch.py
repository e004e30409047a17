"""Bounded host->device prefetch: overlap the NEXT batch's transfer with the
current step's compute.

Port of the reference's `data/prefetch.py`. `DevicePrefetcher` moves the
copy of each item onto a feeder thread behind a BOUNDED queue:

    for dev_batch in DevicePrefetcher(host_batches, depth=2, device=dev):
        step(dev_batch)          # batch k trains while k+1 transfers

depth=2 is classic double buffering — one batch in compute, one in flight.
The bound is the backpressure contract: a slow consumer blocks the feeder
(and, transitively, the upstream chunk workers via `WorkerPool.imap_rows`'s
bounded window) instead of ballooning pinned host memory.

`put=None` copies each item (a numpy array or a tensor) to `device`, which
resolves as the port's entry points do (None -> the card, raising without
one). On a card the feeder copies from pinned host memory with
`non_blocking=True` on its own `torch.cuda.Stream` and records an event per
item; the consumer's stream waits on that event before the item is handed
out (`wait_event`, `record_stream`), so compute never reads a tensor whose
copy has not landed, and the pinned buffer is held until its event has
completed, so no copy reads host memory that was already given back. Any
other `put` is called as it is on the feeder thread.

One `data.prefetch` span covers a prefetcher's lifetime (not each item):
it finishes with the items and stalls totals, so a trace shows whether
the overlap hid the producer. Instrumented through `reliability.metrics`:
  data.prefetch.put          — feeder time spent in `put` (wall clock)
  data.prefetch.items        — batches fed
  data.prefetch.stalls       — consumer arrived at an EMPTY queue (the
                               overlap failed to hide the producer)
  data.prefetch.full         — feeder found the queue full (healthy: the
                               device is the bottleneck, ingest keeps up)
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..reliability import names as tnames
from ..reliability.metrics import reliability_metrics
from ..telemetry.spans import get_tracer
from ..utils import tracing

_DONE = object()


class _InFlight:
    """A copy issued on the prefetcher's stream: the device tensor, the
    event recorded after the copy, and the pinned source it reads."""

    __slots__ = ("tensor", "event", "pinned")

    def __init__(self, tensor, event, pinned):
        self.tensor = tensor
        self.event = event
        self.pinned = pinned


class _StreamCopy:
    """`put` of a CUDA device: pinned host buffer, `non_blocking` copy on a
    side stream, one event per item."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)

    def __call__(self, item) -> _InFlight:
        host = item if torch.is_tensor(item) \
            else torch.from_numpy(np.ascontiguousarray(item))
        pinned = host if host.is_pinned() else host.pin_memory()
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            dev = pinned.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return _InFlight(dev, event, pinned)


class DevicePrefetcher:
    """Iterate the device copies of `source`'s items with a feeder thread
    and a bounded queue. `put=None` copies to `device` (module doc); pass
    any callable to prefetch other per-item work. `step_clock`
    (`telemetry.goodput.StepClock`) books the consumer's mid-stream waits
    as data-wait."""

    def __init__(self, source: Iterable, depth: int = 2,
                 put: Optional[Callable] = None, metrics=None,
                 step_clock=None, device=None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if put is None:
            dev = resolve_device(device)
            put = _StreamCopy(dev) if dev.type == "cuda" else \
                (lambda item: torch.as_tensor(np.asarray(item)).to(dev)
                 if not torch.is_tensor(item) else item.to(dev))
        self._put = put
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._metrics = metrics if metrics is not None else reliability_metrics
        self._clock = step_clock
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._feed, daemon=True,
                                        name="ingest-prefetch")
        self._started = False
        self._consumed = 0
        self._stalls = 0
        self._span = None   # lifecycle span: started with the feeder
        # handed-out copies whose pinned source may still be read
        self._pinned: collections.deque = collections.deque()

    def queue_depth(self) -> int:
        """Items ready in the queue now (approximate; for monitoring)."""
        return self._q.qsize()

    @property
    def stalls(self) -> int:
        """Mid-stream waits on an empty queue so far."""
        return self._stalls

    # -- feeder --------------------------------------------------------------
    def _feed(self) -> None:
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                with tracing.wall_clock(tnames.DATA_PREFETCH_PUT,
                                        sink=self._metrics.observe):
                    dev = self._put(item)
                self._metrics.inc(tnames.DATA_PREFETCH_ITEMS)
                if self._q.full():
                    self._metrics.inc(tnames.DATA_PREFETCH_FULL)
                self._q_put(dev)
            self._q_put(_DONE)
        except BaseException as e:  # noqa: BLE001 - re-raised in consumer
            self._q_put(e if isinstance(e, Exception)
                        else RuntimeError(repr(e)))

    def _q_put(self, item) -> None:
        """Bounded put that stays responsive to close()."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    # -- consumer ------------------------------------------------------------
    def __iter__(self) -> Iterator:
        if not self._started:
            self._started = True
            self._span = get_tracer().start_span(
                tnames.DATA_PREFETCH_SPAN, attrs={"depth": self._q.maxsize})
            self._thread.start()
        return self

    def __next__(self):
        if not self._started:
            iter(self)
        # a stall is the consumer finding NOTHING ready mid-stream: the
        # cold-start wait and the final wait for the sentinel are inherent
        was_empty = self._consumed > 0 and self._q.empty()
        t_wait = (time.perf_counter()
                  if was_empty and self._clock is not None else None)
        item = self._q.get()
        if item is _DONE:
            self._thread.join(timeout=5)
            self._release(wait=True)
            self._finish_span()
            raise StopIteration
        if isinstance(item, Exception):
            self._stop.set()
            self._finish_span(error=type(item).__name__)
            raise item
        if was_empty:
            if t_wait is not None:
                self._clock.note("data_wait", time.perf_counter() - t_wait)
            self._stalls += 1
            self._metrics.inc(tnames.DATA_PREFETCH_STALLS)
        self._consumed += 1
        if isinstance(item, _InFlight):
            return self._land(item)
        return item

    def _finish_span(self, **attrs) -> None:
        if self._span is not None:
            self._span.finish(items=self._consumed, stalls=self._stalls,
                              **attrs)
            self._span = None

    def _land(self, item: _InFlight):
        """Order the consumer's stream after the item's copy, tie the
        tensor's memory to that stream, and keep the pinned source until
        the copy has completed."""
        stream = torch.cuda.current_stream(item.tensor.device)
        stream.wait_event(item.event)
        item.tensor.record_stream(stream)
        self._pinned.append(item)
        self._release(wait=False)
        return item.tensor

    def _release(self, wait: bool) -> None:
        """Drop the pinned sources whose copies have completed (all of
        them, after waiting, with `wait`)."""
        while self._pinned and (wait or self._pinned[0].event.query()):
            self._pinned.popleft().event.synchronize()

    def close(self) -> None:
        """Abandon the iteration: unblock and join the feeder."""
        self._stop.set()
        try:
            while True:
                item = self._q.get_nowait()
                if isinstance(item, _InFlight):
                    item.event.synchronize()
        except queue.Empty:
            pass
        if self._started:
            self._thread.join(timeout=5)
        self._release(wait=True)
        self._finish_span(closed=True)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def prefetch_to_device(source: Iterable, depth: int = 2,
                       put: Optional[Callable] = None,
                       device=None) -> DevicePrefetcher:
    """Convenience wrapper: `for dev in prefetch_to_device(batches): ...`"""
    return DevicePrefetcher(source, depth=depth, put=put, device=device)
