"""Request-scoped span tracing: one id follows a request across threads,
processes and HTTP hops.

Port of the reference's `telemetry/spans.py`, which is stdlib-only (no
JAX): the same ids, header format, sampling rule and JSONL export, so a
trace that crosses a server of each package reads as one trace. It sits
under `reliability`, `io` and the model layers and imports none of them.

Design:

- `Tracer` holds a bounded ring buffer (`collections.deque(maxlen=...)`) of
  FINISHED spans — a day of traffic cannot grow memory; overflow increments
  a `dropped` counter instead of blocking anything.
- Parent linkage rides a `contextvars.ContextVar`, so spans nest correctly
  across threads spawned with `contextvars.copy_context` and across the
  same thread's call stack; worker threads that process another thread's
  request activate its context explicitly (`tracer.use(span)`).
- **Deterministic head sampling**: the keep/drop decision is made ONCE at
  the trace head and is a pure function of `(trace_id, sample_rate)` —
  `crc32(trace_id)/2^32 < rate` — so every process that sees the same
  trace id independently reaches the same decision (no sampled-flag drift
  between hosts on the same trace). A propagated `X-Trace-Id` header also
  carries the decision explicitly, which wins over recomputation.
- **Tail-based capture (second stage)**: with `tail_latency_ms` set, a
  head-UNSAMPLED trace still records — tentatively, into a bounded
  pending buffer keyed by trace id — and the whole tree is promoted to
  the ring when its ROOT span finishes slow (>= threshold), errored, or
  with a 5xx status; fast clean traces are discarded wholesale. The 1%
  head sample stays a statistically honest picture of ALL traffic while
  every slow/failed request keeps a full span tree. Tentative traces
  never inject propagation headers (the local process can't promise the
  fleet a trace it may yet discard), and eviction is deterministic
  (oldest pending trace first; per-trace span cap) — see stats().
- Propagation: `X-Trace-Id: <trace_id>:<parent_span_id>:<0|1>`. A bare
  value with no `:` is accepted as a sampled trace id (curl-friendly).
- Zero overhead disabled: `sample_rate == 0` with no incoming context makes
  `start_span` return `None` after one float compare; every instrumentation
  site branches on `is not None`.
- JSONL export: `export_jsonl(path)` writes one JSON object per finished
  span, in `seq` order — a process-wide monotonic sequence number that
  makes single-process event logs causally ordered even when wall clocks
  are too coarse to order them.

Events (`tracer.event(name, **attrs)`) are zero-duration spans with
`kind="event"` — supervisor restarts/preemptions and FaultInjector firings
land here, so a chaos run reads as one ordered narrative.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import json
import os
import threading
import time
import uuid
import zlib
from collections import deque
from typing import Callable, NamedTuple, Optional

TRACE_HEADER = "X-Trace-Id"
REQUEST_ID_HEADER = "X-Request-Id"
# env knobs: sampling rate for the process-default tracer (0 = off, the
# production-safe default; serving tests/benches opt in), ring capacity,
# and the tail-capture latency threshold in ms (unset/<=0 = off)
SAMPLE_ENV = "MMLSPARK_TPU_TRACE_SAMPLE"
CAPACITY_ENV = "MMLSPARK_TPU_TRACE_CAPACITY"
TAIL_ENV = "MMLSPARK_TPU_TRACE_TAIL_MS"

# tail-capture bounds: pending traces awaiting their root's verdict, and
# spans buffered per pending trace (a runaway recursive trace must not
# grow memory); both deterministic — overflow evicts the OLDEST pending
# trace / drops further spans, counted in stats()
TAIL_PENDING_TRACES = 256
TAIL_SPANS_PER_TRACE = 512

_UNSET = object()


class SpanContext(NamedTuple):
    """The propagated identity of a trace position: enough to parent a new
    span (local or remote) and to carry the head-sampling decision."""
    trace_id: str
    span_id: str
    sampled: bool

    def header_value(self) -> str:
        return f"{self.trace_id}:{self.span_id}:{1 if self.sampled else 0}"


_current: contextvars.ContextVar = contextvars.ContextVar(
    "mmlspark_tpu_torch_trace_ctx", default=None)


# One wall-clock anchor per process, captured once at import: epoch-valued
# timestamps are derived as anchor + perf_counter(), so they ADVANCE
# MONOTONICALLY — an NTP step mid-run cannot reorder span starts against
# their seq numbers, make a heartbeat look fresh/stale by hours, or
# interleave usage-log timestamps backwards. (graftlint's `wall-clock`
# rule points raw time.time() call sites here.)
_WALL_ANCHOR = time.time() - time.perf_counter()  # graftlint: disable=wall-clock


def wall_now() -> float:
    """Epoch-valued timestamp that advances monotonically (never steps
    backward with NTP): the process-start wall clock plus the monotonic
    perf_counter. Use for timestamps that get COMPARED or ordered —
    span starts, heartbeats, event logs."""
    return _WALL_ANCHOR + time.perf_counter()


def new_id() -> str:
    """16-hex span/trace id (uuid4-derived: unique without coordination)."""
    return uuid.uuid4().hex[:16]


def head_sampled(trace_id: str, rate: float) -> bool:
    """The deterministic head-sampling decision: a pure function of the
    trace id, so independent processes agree without a propagated flag."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return (zlib.crc32(trace_id.encode()) & 0xFFFFFFFF) / 4294967296.0 < rate


def parse_trace_header(value: str) -> Optional[SpanContext]:
    """`trace:parent_span:flag` (or a bare trace id, treated as sampled)."""
    if not value:
        return None
    parts = value.strip().split(":")
    if len(parts) == 1:
        return SpanContext(parts[0], "", True)
    if len(parts) >= 3:
        return SpanContext(parts[0], parts[1], parts[2] not in ("0", ""))
    return SpanContext(parts[0], parts[1], True)


class Span:
    """One timed region. Created by `Tracer.start_span` (never directly);
    lands in the tracer's ring buffer when `finish()` is called. Safe to
    finish from a different thread than the one that started it; finish is
    idempotent (serving's reply/expiry race may touch a span twice)."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start_s",
                 "attrs", "duration_ms", "kind", "_t0", "_tracer",
                 "_finished")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: Optional[str],
                 attrs: Optional[dict]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self._t0 = time.perf_counter()
        # derived from the same monotonic reading as duration: span starts
        # order consistently with seq even across an NTP step
        self.start_s = _WALL_ANCHOR + self._t0
        self.attrs = dict(attrs) if attrs else {}
        self.duration_ms = 0.0
        self.kind = "span"
        self._tracer = tracer
        self._finished = False

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, True)

    def finish(self, **attrs) -> None:
        # test-and-set under the tracer lock: the serving reply/expiry race
        # can call finish from two threads at once, and an unsynchronized
        # flag would append the span twice with conflicting statuses
        with self._tracer._lock:
            if self._finished:
                return
            self._finished = True
        self.duration_ms = (time.perf_counter() - self._t0) * 1000.0
        if attrs:
            self.attrs.update(attrs)
        self._tracer._append(self)

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start": self.start_s, "duration_ms": self.duration_ms,
                "kind": self.kind, "attrs": self.attrs}

    def __repr__(self):
        return (f"Span({self.name} trace={self.trace_id} id={self.span_id} "
                f"{self.duration_ms:.3f}ms)")


class Tracer:
    """Span factory + bounded ring of finished spans. Thread-safe."""

    def __init__(self, sample: Optional[float] = None,
                 capacity: Optional[int] = None,
                 tail_latency_ms: Optional[float] = _UNSET):
        if sample is None:
            sample = float(os.environ.get(SAMPLE_ENV, "0") or 0)
        if capacity is None:
            capacity = int(os.environ.get(CAPACITY_ENV, "4096") or 4096)
        if tail_latency_ms is _UNSET:
            tail = float(os.environ.get(TAIL_ENV, "0") or 0)
            tail_latency_ms = tail if tail > 0.0 else None
        self._lock = threading.Lock()
        self._sample = float(sample)
        self._spans: deque = deque(maxlen=max(int(capacity), 1))
        self._dropped = 0
        self._seq = itertools.count()
        # tail-capture second stage (see module docstring): head-unsampled
        # traces buffer here until their ROOT finishes, then the whole
        # tree is kept (breach) or discarded (fast + clean)
        self._tail_ms = (None if tail_latency_ms is None
                         else float(tail_latency_ms))
        self._pending: dict = {}    # trace_id -> {"root": sid, "spans": []}
        self._pending_cap = TAIL_PENDING_TRACES
        # evicted pending traces leave a bounded tombstone so their late
        # spans (children in flight, the root's eventual finish) are
        # dropped instead of leaking into the ring unsampled
        self._tombstones: dict = {}   # trace_id -> None, insertion-ordered
        self._tail_kept = 0
        self._tail_dropped = 0
        self._tail_evicted = 0

    # -- configuration -------------------------------------------------------
    @property
    def sample_rate(self) -> float:
        return self._sample

    @property
    def tail_latency_ms(self) -> Optional[float]:
        """Tail-capture threshold (ms); None = tail stage off."""
        return self._tail_ms

    def configure(self, sample: Optional[float] = None,
                  capacity: Optional[int] = None,
                  tail_latency_ms=_UNSET,
                  tail_pending: Optional[int] = None) -> "Tracer":
        with self._lock:
            if sample is not None:
                self._sample = float(sample)
            if capacity is not None:
                self._spans = deque(self._spans,
                                    maxlen=max(int(capacity), 1))
            if tail_latency_ms is not _UNSET:
                # None disables; a number (ms) enables the second stage
                self._tail_ms = (None if tail_latency_ms is None
                                 else float(tail_latency_ms))
                if self._tail_ms is None:
                    self._pending.clear()
                    self._tombstones.clear()
            if tail_pending is not None:
                self._pending_cap = max(int(tail_pending), 1)
        return self

    # -- context propagation -------------------------------------------------
    def current(self) -> Optional[SpanContext]:
        return _current.get()

    def extract(self, headers: Optional[dict]) -> Optional[SpanContext]:
        """Pull a SpanContext out of an HTTP header dict, case-insensitive:
        serving's selector transport lowercases keys, http.client sends
        them as given, and urllib CAPITALIZES to 'X-trace-id' — all three
        spellings must resolve or propagation silently drops."""
        if not headers:
            return None
        value = headers.get(TRACE_HEADER) or headers.get(TRACE_HEADER.lower())
        if value is None:
            low = TRACE_HEADER.lower()
            for k, v in headers.items():
                if isinstance(k, str) and k.lower() == low:
                    value = v
                    break
        if value is None:
            return None
        return parse_trace_header(value)

    def inject(self, headers: Optional[dict] = None,
               ctx: Optional[SpanContext] = None) -> dict:
        """Add the active (or given) SAMPLED context to an outbound header
        dict; returns {} / the dict unchanged when there is nothing to
        propagate — callers can merge unconditionally."""
        ctx = ctx if ctx is not None else _current.get()
        if headers is None:
            headers = {}
        if ctx is not None and ctx.sampled:
            # a TENTATIVE (tail-pending) trace must not propagate as
            # sampled: the header would force every downstream process to
            # record a trace whose fate this process hasn't decided yet.
            # Evicted/discarded traces (tombstoned) stay silent too —
            # their local spans are already gone.
            if ((self._pending and ctx.trace_id in self._pending)
                    or (self._tombstones
                        and ctx.trace_id in self._tombstones)):
                return headers
            headers[TRACE_HEADER] = ctx.header_value()
        return headers

    @contextlib.contextmanager
    def use(self, span_or_ctx):
        """Activate a span/context on THIS thread (worker threads processing
        another thread's request adopt its trace here)."""
        ctx = (span_or_ctx.context if isinstance(span_or_ctx, Span)
               else span_or_ctx)
        token = _current.set(ctx)
        try:
            yield ctx
        finally:
            _current.reset(token)

    # -- span creation -------------------------------------------------------
    def start_span(self, name: str, parent=_current,
                   trace_id: Optional[str] = None,
                   span_id: Optional[str] = None,
                   attrs: Optional[dict] = None) -> Optional[Span]:
        """Begin a span; returns None when the trace is unsampled (callers
        branch on `is not None` — the disabled path is one compare).

        `parent` defaults to the ambient contextvar; pass an explicit Span /
        SpanContext / None (None forces a new trace head). `trace_id` /
        `span_id` override generation — serving uses the ingress request id
        as both the fresh trace id and the root span id so the id a client
        sees IS the trace id."""
        if parent is _current:
            parent = _current.get()
        if isinstance(parent, Span):
            parent = parent.context
        if parent is not None:
            if not parent.sampled:
                return None
            tid, pid = parent.trace_id, parent.span_id or None
        else:
            tail = self._tail_ms
            if self._sample <= 0.0 and tail is None:
                return None
            tid = trace_id if trace_id is not None else new_id()
            pid = None
            if not head_sampled(tid, self._sample):
                if tail is None:
                    return None
                # tail second stage: record TENTATIVELY — the trace
                # buffers in _pending until this root span finishes, and
                # is kept only if the root breached (slow/error/5xx)
                sid = span_id or new_id()
                with self._lock:
                    if tid not in self._pending:
                        if len(self._pending) >= self._pending_cap:
                            # deterministic eviction: oldest pending trace
                            oldest = next(iter(self._pending))
                            gone = self._pending.pop(oldest)
                            self._tail_evicted += 1 + len(gone["spans"])
                            self._tombstone(oldest)
                        self._tombstones.pop(tid, None)
                        self._pending[tid] = {"root": sid, "spans": []}
                return Span(self, name, tid, sid, pid, attrs)
        return Span(self, name, tid, span_id or new_id(), pid, attrs)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Context-manager span, activated on the current thread; yields the
        Span or None. An escaping exception is recorded as `error=<type>`
        before re-raising — restarted/retried work stays visible."""
        sp = self.start_span(name, attrs=attrs or None)
        if sp is None:
            yield None
            return
        token = _current.set(sp.context)
        try:
            yield sp
        except BaseException as e:
            sp.finish(error=type(e).__name__)
            raise
        finally:
            _current.reset(token)
            sp.finish()

    def trace(self, name: Optional[str] = None, **attrs) -> Callable:
        """Decorator form: `@tracer.trace("stage.encode")`."""
        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapped(*args, **kwargs):
                with self.span(label, **attrs):
                    return fn(*args, **kwargs)
            return wrapped
        return deco

    def record(self, name: str, parent=_current, duration_ms: float = 0.0,
               start_s: Optional[float] = None, kind: str = "span",
               attrs: Optional[dict] = None) -> Optional[dict]:
        """Append an already-measured span post-hoc (batch workers stamp one
        per request AFTER the shared transform ran; `observe` sinks land
        here). Sampling rules match start_span; returns the recorded dict
        or None."""
        sp = self.start_span(name, parent=parent, attrs=attrs)
        if sp is None:
            return None
        sp.kind = kind
        # a post-hoc span is recorded at the END of its interval: backdate
        # the start by the duration so children sit INSIDE their parent on
        # a timeline instead of dangling past its end
        sp.start_s = (start_s if start_s is not None
                      else sp.start_s - float(duration_ms) / 1000.0)
        sp.duration_ms = float(duration_ms)
        sp._finished = True
        self._append(sp)
        return sp.to_dict()

    def event(self, name: str, parent=_current, **attrs) -> Optional[dict]:
        """Point-in-time structured event (kind="event"): recorded under the
        active sampled trace, or as a trace of its own when sampling is on —
        supervisor preemptions and injected faults must appear in the chaos
        log even when no request context is active."""
        return self.record(name, parent=parent, duration_ms=0.0,
                           kind="event", attrs=attrs or None)

    def observe(self, label: str, seconds: float) -> Optional[dict]:
        """`(label, seconds)` sink — the same signature as
        `MetricsRegistry.observe`, so `utils.tracing.wall_clock(...,
        sink=tracer.observe)` turns timed blocks into spans. Returns the
        recorded span dict, or None when sampling dropped it — callers
        that REPLACE another output with the span (Timer's print) use
        this to fall back instead of losing the timing."""
        return self.record(label, duration_ms=seconds * 1000.0)

    # -- ring buffer / export ------------------------------------------------
    def _tombstone(self, trace_id: str) -> None:
        """Remember (bounded, oldest-out) that a tentative trace was
        evicted/discarded: its late spans drop instead of leaking into
        the ring unsampled, and it never injects headers. Caller holds
        the tracer lock."""
        if len(self._tombstones) >= self._pending_cap:
            self._tombstones.pop(next(iter(self._tombstones)))
        self._tombstones[trace_id] = None

    def _tail_breach(self, d: dict) -> bool:
        """Did this root span earn its trace a place in the ring? Slow
        (>= threshold), errored, or answered 5xx — 'every slow/failed
        request has a full span tree'."""
        tail = self._tail_ms
        if tail is not None and d["duration_ms"] >= tail:
            return True
        attrs = d["attrs"]
        if attrs.get("error") is not None:
            return True
        status = attrs.get("status")
        return isinstance(status, int) and status >= 500

    def _ring_append(self, d: dict) -> None:
        if len(self._spans) == self._spans.maxlen:
            self._dropped += 1
        self._spans.append(d)

    def _append(self, span: Span) -> None:
        d = span.to_dict()
        with self._lock:
            d["seq"] = next(self._seq)
            d["pid"] = os.getpid()
            if self._tombstones and span.trace_id in self._tombstones:
                self._tail_dropped += 1   # late span of an evicted trace
                return
            if self._pending:
                entry = self._pending.get(span.trace_id)
                if entry is not None:
                    if span.span_id == entry["root"]:
                        # the root's finish is the tail decision point
                        del self._pending[span.trace_id]
                        if self._tail_breach(d):
                            d["attrs"] = dict(d["attrs"], tail=True)
                            self._tail_kept += 1
                            for s in entry["spans"]:
                                self._ring_append(s)
                            self._ring_append(d)
                        else:
                            self._tail_dropped += 1 + len(entry["spans"])
                            # discarded wholesale means late stragglers
                            # too: a child finishing after its fast root
                            # must not leak into the ring
                            self._tombstone(span.trace_id)
                    elif len(entry["spans"]) < TAIL_SPANS_PER_TRACE:
                        entry["spans"].append(d)
                    else:
                        self._tail_dropped += 1
                    return
            self._ring_append(d)

    def finished(self, name: Optional[str] = None) -> list:
        """Finished span dicts in seq (causal) order; `name` filters."""
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s["name"] == name]
        return out

    def pending_tail(self) -> list:
        """Snapshot of the tail stage's TENTATIVE traces — the span trees
        still waiting on their root's verdict. The flight recorder dumps
        these next to the ring: at the moment of distress, the request
        most worth seeing is often the one still in flight.
        `[{"trace_id", "root", "spans": [...]}]`, insertion order."""
        with self._lock:
            return [{"trace_id": tid, "root": e["root"],
                     "spans": list(e["spans"])}
                    for tid, e in self._pending.items()]

    def export_jsonl(self, path: str, clear: bool = False) -> int:
        """Write the ring to a JSONL file (one span per line, seq order);
        returns the number of spans written."""
        spans = self.finished()
        with open(path, "w") as f:
            for s in spans:
                f.write(json.dumps(s) + "\n")
        if clear:
            self.clear()
        return len(spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._pending.clear()
            self._tombstones.clear()
            self._dropped = 0
            self._tail_kept = 0
            self._tail_dropped = 0
            self._tail_evicted = 0

    def stats(self) -> dict:
        with self._lock:
            return {"spans": len(self._spans), "dropped": self._dropped,
                    "capacity": self._spans.maxlen,
                    "sample_rate": self._sample,
                    "tail_latency_ms": self._tail_ms,
                    "tail_pending": len(self._pending),
                    "tail_kept": self._tail_kept,
                    "tail_dropped": self._tail_dropped,
                    "tail_evicted": self._tail_evicted}


def read_jsonl(path: str) -> list:
    """Load a JSONL export back into span dicts (test/analysis helper)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


# Process-wide default: instrumentation sites record here unless handed a
# private tracer (mirrors reliability_metrics). Sampling comes from
# MMLSPARK_TPU_TRACE_SAMPLE (default 0 = off; `configure(sample=...)`
# flips it at runtime).
_default = Tracer()


def get_tracer() -> Tracer:
    return _default


def configure(sample: Optional[float] = None,
              capacity: Optional[int] = None,
              tail_latency_ms=_UNSET,
              tail_pending: Optional[int] = None) -> Tracer:
    """Configure the process-default tracer (sampling rate / ring size /
    tail-capture threshold)."""
    return _default.configure(sample=sample, capacity=capacity,
                              tail_latency_ms=tail_latency_ms,
                              tail_pending=tail_pending)
