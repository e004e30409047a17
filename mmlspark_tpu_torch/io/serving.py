"""Model serving runtime: HTTP in -> pipeline -> HTTP reply, with
epoch-based replay fault tolerance.

Port of the reference's `io/serving.py` (stdlib and numpy; role: Spark
Serving's HTTPSourceV2.scala):

- `ServingServer` is the WorkerServer: an HTTP ingress (an event-loop
  `selector` transport, or the stdlib `threading` one) whose handler
  holds each exchange as a `CachedRequest` in one of N partition queues
  and blocks the client until `reply_to` routes its response back.
  Requests round-robin over the partitions; a queue past `max_queue`
  answers 503 at once (load shedding), and `stop()` drains: new
  connections are refused, new requests answered 503, held ones answered
  and flushed.
- Epoch replay: each partition drains its queue in epochs; a batch stays
  in `history` until `commit(epoch, pid)`. A worker that dies between
  read and commit is restarted by the watchdog and gets the batch again
  (`registerPartition` recovery), so in-flight HTTP requests survive
  worker death; a batch that keeps failing is retried row by row and the
  rows that still fail answer 502.
- `ServingQuery` is the streaming engine: one worker thread per
  partition pulls a batch, runs the transform, replies per row and
  commits. `mode="continuous"` scores batches of one; `batch_linger_ms`
  coalesces arrivals in microbatch mode.
- `serve_pipeline(model, input_cols)` mounts the compiled transform of
  `io/plan.py` (the plan cache; GBDT on its host plan, card stages at
  power-of-two buckets) on a server and a query; `fast_path=False`
  mounts the uncached Table-per-batch transform instead.
- The exposition GETs (`EXPOSITION_PATHS`) are answered at ingress on
  both transports by `telemetry.exposition.metrics_http_response`.

Every transform runs on a partition's worker thread; a stage on the card
scores there and its results come back to the host before the reply is
encoded. `admission=` mounts a burn-aware admission controller
(`control.actuators.BurnAwareAdmission`): while the SLO error budget
burns, requests past its queue allowance answer 503 with `Retry-After`
before they queue.
"""
from __future__ import annotations

import collections
import itertools
import json
import selectors
import socket
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, NamedTuple, Optional

import numpy as np

from ..reliability.faults import FaultInjector, InjectedCrash
from ..reliability.metrics import reliability_metrics
from ..telemetry.spans import TRACE_HEADER, get_tracer
from ..telemetry import names as tnames


class Reply(NamedTuple):
    """A transform's per-row answer with explicit status/content-type —
    lets a transform 400 one malformed row (or return preserialized JSON
    bytes) without touching its batch-mates. Plain dict/str/bytes replies
    keep working; this is the typed superset the fast path (io/plan.py)
    emits."""
    data: object
    status: int = 200
    content_type: Optional[str] = None
    # the ModelVersion id that scored this row (io/plan.py versioned
    # handle); rides out as the X-Model-Version response header
    version: Optional[str] = None


# request-id source: a process-unique counter under a random run prefix.
# uuid4 per exchange costs ~2 us of entropy the ingress hot path doesn't
# need — routing only requires per-process uniqueness
_REQ_PREFIX = uuid.uuid4().hex[:8]
_REQ_IDS = itertools.count()


class CachedRequest:
    """One held HTTP exchange (reference: CachedRequest, HTTPSourceV2.scala:519)."""

    __slots__ = ("id", "body", "headers", "path", "_event", "_response",
                 "_on_respond", "t_enqueue", "span", "slo", "version",
                 "retry_after")

    def __init__(self, body: bytes, headers: dict, path: str,
                 on_respond=None):
        self.id = f"{_REQ_PREFIX}-{next(_REQ_IDS)}"
        self.body = body
        self.headers = headers
        self.path = path
        self._event = threading.Event()
        self._response: Optional[tuple] = None
        self._on_respond = on_respond   # selector transport wakeup
        self.t_enqueue = 0.0            # stamped by ServingServer._enqueue
        self.span = None                # ingress root span (telemetry)
        self.slo = False                # counted in serving.request.*
        #                                 (exposition self-scrapes are not)
        self.version = None             # X-Model-Version response stamp
        self.retry_after = None         # Retry-After seconds on a shed 503

    def respond(self, status: int, body: bytes,
                content_type: str = "application/json"):
        if self.slo and self._response is None and status >= 500:
            # SLO error-budget numerator: 5xx of any flavor (shed 503,
            # expiry 504, model 502). First responder wins the count (the
            # reply/expiry race may call respond twice); the slo flag
            # gates out exposition exchanges, which must not burn budget
            reliability_metrics.inc(tnames.SERVING_REQUEST_ERRORS)
        self._response = (status, body, content_type)
        if self.span is not None:
            # root span ends when the response is ROUTED (what the held
            # client experiences); finish is idempotent — the expiry/reply
            # race may touch it twice
            self.span.finish(status=status)
        self._event.set()
        if self._on_respond is not None:
            self._on_respond()

    def wait(self, timeout: Optional[float]):
        ok = self._event.wait(timeout)
        return self._response if ok else None


class _Handler(BaseHTTPRequestHandler):
    server_version = "mmlspark_tpu_torch-serving/1.0"

    def do_POST(self):  # noqa: N802 (stdlib naming)
        serving: "ServingServer" = self.server.serving  # type: ignore
        if self.path.split("?", 1)[0] in EXPOSITION_PATHS:
            # self-scrape exclusion: exposition answered here, never
            # enqueued — a POSTing poller must not ride the worker path
            # or inflate serving.request.* counts
            status, payload, ctype = serving._metrics_response(self.path)
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = -1
        if length < 0 or length > MAX_BODY_BYTES:
            # same status split as the selector transport: 413 for
            # oversized, 400 for malformed/negative
            self.send_response(413 if length > MAX_BODY_BYTES else 400)
            self.end_headers()
            self.wfile.write(b'{"error": "invalid Content-Length"}')
            return
        body = self.rfile.read(length)
        cached = CachedRequest(body, dict(self.headers), self.path)
        serving._enqueue(cached)
        resp = cached.wait(serving.reply_timeout)
        if resp is None:
            # the CLIENT sees 504: stamp the span to agree. Best-effort —
            # finish is first-wins, so a worker reply landing in the
            # microseconds between wait() expiring and this line can still
            # record its 200; without this stamp EVERY timed-out request
            # recorded the worker's status instead of the client's
            if cached.span is not None:
                cached.span.finish(status=504, timeout=True)
            # route the 504 through respond() so the error-budget count
            # happens exactly once: a worker reply landing later sees
            # _response set and skips its own count (a bare counter inc
            # here double-counted that race)
            cached.respond(504, b'{"error": "serving timeout"}')
            self.send_response(504)
            # the correlation id must ride EVERY response — the slow
            # request that timed out is exactly the one worth tracing
            self.send_header("X-Request-Id", cached.id)
            self.end_headers()
            self.wfile.write(b'{"error": "serving timeout"}')
            return
        status, payload, ctype = resp
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        # client-visible correlation id == server-side root span id
        self.send_header("X-Request-Id", cached.id)
        if cached.version is not None:
            # which ModelVersion answered (hot-swap attribution)
            self.send_header("X-Model-Version", cached.version)
        if cached.retry_after is not None:
            # burn-aware shed: tell the client WHEN to come back instead
            # of letting it hammer a burning budget (RFC 9110 §10.2.3)
            self.send_header("Retry-After", str(int(cached.retry_after)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):  # noqa: N802
        serving: "ServingServer" = self.server.serving  # type: ignore
        path = self.path.split("?", 1)[0]
        if path in EXPOSITION_PATHS:
            # full path rides through: ?window= selects the shard-merged
            # recent view instead of cumulative-since-start
            status, payload, ctype = serving._metrics_response(self.path)
        else:
            status, ctype = 404, "application/json"
            payload = b'{"error": "not found"}'
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, *args):  # quiet
        pass


class _ThreadingServer(ThreadingHTTPServer):
    daemon_threads = True
    # stdlib default listen backlog is 5: a 16-client burst overflows it and
    # connections get RST before accept() ever runs. Serving ingress must
    # absorb bursts (reference WorkerServer rides Jetty's default 128).
    request_queue_size = 128


_REASONS = {200: "OK", 400: "Bad Request", 413: "Payload Too Large",
            429: "Too Many Requests", 500: "Internal Server Error",
            501: "Not Implemented", 502: "Bad Gateway",
            503: "Service Unavailable", 504: "Gateway Timeout"}

# Exposition endpoints answered at ingress on BOTH transports: never
# enqueued to partition workers, never shed during drain, and excluded
# from serving.request.* metrics (a self-scrape must not move the SLO
# it reports on). /debug/bundle is the on-demand flight-recorder dump
# (telemetry/perf.py) — reachable even on a server whose workers are
# wedged, which is exactly when you want the bundle. /debug/profile is
# the triggered device-profile capture (telemetry/profiler.py) with the
# same 429/503/500 contract; its ?ms=N window blocks the handler, so it
# is rate-limited and ms-clamped. /quality is the model-quality export
# (telemetry/quality.py): reference/live sketch states, drift rows, and
# streaming-eval state — scrape_cluster(quality=True) merges it
# fleet-wide. /versions is the deployment-observability export
# (telemetry/lineage.py): tracked ModelVersions' lineage, per-version
# latency/error splits, and the candidate-vs-incumbent canary values —
# scrape_cluster(versions=True) merges it and tracks rollout skew.
EXPOSITION_PATHS = ("/metrics", "/metrics.json", "/slo", "/quality",
                    "/versions", "/debug/bundle", "/debug/profile")

# Ingress bounds: a header block or body beyond these is rejected and the
# connection closed — the single-threaded loop must never be wedged (or its
# memory grown without bound) by one misbehaving client.
MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024

# (status, content_type) -> preencoded response-line + Content-Type header:
# the write path's f-string + .encode per response was measurable at
# 5k req/s; the handful of distinct pairs is cached forever
_HDR_CACHE: dict = {}


def _response_head(status: int, ctype: str) -> bytes:
    head = _HDR_CACHE.get((status, ctype))
    if head is None:
        head = _HDR_CACHE[(status, ctype)] = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
            f"Content-Type: {ctype}\r\nContent-Length: "
        ).encode("latin-1")
    return head


class _SelectorConn:
    __slots__ = ("sock", "rbuf", "wbuf", "inflight", "closed", "reject",
                 "closing")

    def __init__(self, sock):
        self.sock = sock
        self.rbuf = b""
        self.wbuf = b""
        self.inflight = collections.deque()
        self.closed = False
        self.reject = None    # pending error response (protocol violation)
        self.closing = False  # close once wbuf fully drains


class _SelectorServer:
    """Event-loop HTTP ingress: one thread, epoll/kqueue readiness,
    keep-alive connections, responses routed back through a wakeup pipe.

    The thread-per-connection stdlib server spends its time on thread
    switches and per-request connection setup — measured ~1,300 req/s at
    16 clients on the CI host. This front end holds every exchange as the
    same CachedRequest the workers already consume (epoch replay
    untouched) but parses/writes all sockets in one loop: no thread per
    request, no GIL hand-offs on the hot path. The reference's design
    point is the per-executor native HttpServer (HTTPSourceV2.scala:
    475-697); this is the Python-runtime equivalent of that choice."""

    def __init__(self, addr, serving):
        self.serving = serving
        self._sel = selectors.DefaultSelector()
        self._lsock = socket.create_server(addr, backlog=512)
        self._lsock.setblocking(False)
        self.server_address = self._lsock.getsockname()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._ready = collections.deque()
        self._stop = threading.Event()
        self._refuse_new = False   # drain: accept() then immediately close
        self._sel.register(self._lsock, 1, ("accept", None))   # EVENT_READ
        self._sel.register(self._wake_r, 1, ("wake", None))
        self._deadlines: dict = {}

    # -- cross-thread notification (worker respond() -> loop) ----------------
    def _notify(self, conn):
        self._ready.append(conn)
        try:
            self._wake_w.send(b"x")
        except (BlockingIOError, OSError):
            pass  # pipe full = wakeup already pending; loop drains _ready

    def serve_forever(self):
        sel = self._sel
        while not self._stop.is_set():
            for key, mask in sel.select(timeout=0.1):
                kind, conn = key.data
                if kind == "accept":
                    self._accept()
                elif kind == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                else:
                    # one connection's failure must close only that
                    # connection — an uncaught exception here would kill
                    # the single ingress thread and the whole server
                    try:
                        self._io(conn, mask)
                    except Exception:  # noqa: BLE001
                        self._close(conn)
            while self._ready:
                conn = self._ready.popleft()
                if not conn.closed:
                    try:
                        self._flush(conn)
                    except Exception:  # noqa: BLE001
                        self._close(conn)
            self._expire()
        # final drain: responses routed in just before shutdown() must still
        # reach their sockets (stop()'s drain contract: answered AND flushed)
        while self._ready:
            conn = self._ready.popleft()
            if not conn.closed:
                try:
                    self._flush(conn)
                except Exception:  # noqa: BLE001
                    self._close(conn)

    def stop_accepting(self):
        """Graceful-drain step 1: refuse NEW connections while held ones
        keep being answered. Flag-based — only the loop thread touches the
        selector, so this is safe to call from any thread."""
        self._refuse_new = True

    def pending_exchanges(self) -> bool:
        """Any unanswered in-flight request or undrained write buffer?
        Best-effort read from the drain thread; the loop owns the maps."""
        try:
            if self._ready:
                return True  # answered responses not yet serialized
            for _rid, (_, req) in list(self._deadlines.items()):
                if not req._event.is_set():
                    return True
            for key in list(self._sel.get_map().values()):
                kind, conn = key.data
                # ANY inflight exchange counts: an answered request leaves
                # conn.inflight only when its response reaches wbuf, so a
                # respond() racing the loop's _ready drain is still seen
                if kind == "conn" and (conn.wbuf or conn.inflight):
                    return True
        except (RuntimeError, KeyError):  # map mutated under us: stay safe
            return True
        return False

    def _accept(self):
        while True:
            try:
                sock, _ = self._lsock.accept()
            except (BlockingIOError, OSError):
                return
            if self._refuse_new:
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _SelectorConn(sock)
            self._sel.register(sock, 1, ("conn", conn))

    def _io(self, conn, mask):
        if mask & selectors.EVENT_WRITE and conn.wbuf:
            self._send_buffered(conn)
            if conn.closed:
                return
        if not mask & selectors.EVENT_READ:
            return
        try:
            data = conn.sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._close(conn)
            return
        if not data:
            self._close(conn)
            return
        if conn.reject is not None or conn.closing:
            return  # desynced/closing stream: ignore bytes until close
        conn.rbuf += data
        self._parse(conn)

    def _reject(self, conn, status: int, msg: str):
        """Error reply + close for protocol violations (the connection byte
        stream can no longer be trusted). HTTP/1.1 responses must stay in
        request order per connection: if earlier exchanges are still in
        flight (or partially written), the error is queued AFTER them via
        conn.reject and the close deferred until the write buffer drains —
        a direct send() here would splice the error into the middle of a
        pipelined predecessor's response."""
        payload = json.dumps({"error": msg}).encode()
        resp = (f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(payload)}\r\n"
                f"Connection: close\r\n\r\n").encode("latin-1") + payload
        conn.rbuf = b""   # the stream is desynced: never re-parse it
        if not conn.inflight and not conn.wbuf:
            # even the "nothing queued" fast path must go through the write
            # buffer: a direct send() on this non-blocking socket can accept
            # only part of the reply (or none, EAGAIN) and the close would
            # truncate the 4xx/501 mid-payload. wbuf + closing gets the
            # partial-write retry and deferred close for free.
            conn.wbuf += resp
            conn.closing = True
            self._send_buffered(conn)
            return
        conn.reject = resp
        self._flush(conn)

    def _parse(self, conn):
        while True:
            head_end = conn.rbuf.find(b"\r\n\r\n")
            if head_end < 0:
                if len(conn.rbuf) > MAX_HEADER_BYTES:
                    self._reject(conn, 400, "header block too large")
                return
            head = conn.rbuf[:head_end].decode("latin-1")
            lines = head.split("\r\n")
            try:
                _method, path, _ver = lines[0].split(" ", 2)
            except ValueError:
                self._close(conn)
                return
            headers = {}
            for ln in lines[1:]:
                k, _, v = ln.partition(":")
                headers[k.strip().lower()] = v.strip()
            if "chunked" in headers.get("transfer-encoding", "").lower():
                # chunked framing isn't parsed here; accepting it would
                # desync every later request on this connection
                self._reject(conn, 501, "chunked transfer-encoding "
                                        "not supported")
                return
            try:
                length = int(headers.get("content-length", 0))
            except ValueError:
                self._reject(conn, 400, "malformed Content-Length")
                return
            if length < 0 or length > MAX_BODY_BYTES:
                self._reject(conn, 400 if length < 0 else 413,
                             "invalid Content-Length")
                return
            total = head_end + 4 + length
            if len(conn.rbuf) < total:
                return
            body = conn.rbuf[head_end + 4:total]
            conn.rbuf = conn.rbuf[total:]
            bare_path = path.split("?", 1)[0]
            if bare_path in EXPOSITION_PATHS:
                # exposition endpoint: answered on the loop thread, never
                # enqueued to partition workers (and exempt from ingress
                # fault injection / drain shedding — the scrape is how you
                # WATCH a draining server). Rides the normal in-order
                # response machinery so pipelined predecessors stay
                # intact; the full path carries any ?window= query.
                req = CachedRequest(body, headers, path)
                conn.inflight.append(req)
                status, payload, ctype = \
                    self.serving._metrics_response(path)
                req.respond(status, payload, ctype)
                self._flush(conn)
                continue
            inj = self.serving._faults
            if inj is not None:
                fault = inj.fire("serving.ingress")
                if fault is not None and fault.kind == "reset":
                    # injected connection reset: drop the socket mid-exchange
                    # — the client's retry layer, not this request, must
                    # recover (nothing was enqueued)
                    self._close(conn)
                    return
            req = CachedRequest(body, headers, path,
                                on_respond=None)
            req._on_respond = (lambda c=conn: self._notify(c))
            conn.inflight.append(req)
            self._deadlines[req.id] = (time.monotonic()
                                       + self.serving.reply_timeout, req)
            self.serving._enqueue(req)

    def _flush(self, conn):
        """Write completed responses in request order (HTTP/1.1 requires
        in-order responses per connection)."""
        out = []
        while conn.inflight and conn.inflight[0]._event.is_set():
            req = conn.inflight.popleft()
            self._deadlines.pop(req.id, None)
            status, payload, ctype = req._response
            out.append(_response_head(status, ctype))
            # X-Request-Id echoes the server-side correlation id (== the
            # root span id) so the client can quote it against traces;
            # X-Model-Version names the ModelVersion that answered;
            # Retry-After rides burn-aware shed 503s
            if req.version is None and req.retry_after is None:
                out.append(b"%d\r\nX-Request-Id: %b\r\n\r\n"
                           % (len(payload), req.id.encode("latin-1")))
            else:
                head = b"%d\r\nX-Request-Id: %b" % (
                    len(payload), req.id.encode("latin-1"))
                if req.version is not None:
                    head += (b"\r\nX-Model-Version: %b"
                             % req.version.encode("latin-1"))
                if req.retry_after is not None:
                    head += b"\r\nRetry-After: %d" % int(req.retry_after)
                out.append(head + b"\r\n\r\n")
            out.append(payload)
        if out:
            conn.wbuf += b"".join(out)
        if conn.reject is not None and not conn.inflight:
            # every predecessor answered in order; the error goes last,
            # then the connection closes once the buffer drains
            conn.wbuf += conn.reject
            conn.reject = None
            conn.closing = True
        if conn.wbuf:
            self._send_buffered(conn)
        elif conn.closing:
            self._close(conn)

    def _send_buffered(self, conn):
        try:
            sent = conn.sock.send(conn.wbuf)
            conn.wbuf = conn.wbuf[sent:]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._close(conn)
            return
        if conn.closing and not conn.wbuf:
            self._close(conn)
            return
        # partial write: watch writability until the buffer drains, then
        # drop back to read-only interest
        want = (selectors.EVENT_READ | selectors.EVENT_WRITE if conn.wbuf
                else selectors.EVENT_READ)
        try:
            if self._sel.get_key(conn.sock).events != want:
                self._sel.modify(conn.sock, want, ("conn", conn))
        except KeyError:
            pass

    def _expire(self):
        if not self._deadlines:
            return
        now = time.monotonic()
        for rid in [r for r, (dl, _) in self._deadlines.items() if dl < now]:
            _, req = self._deadlines.pop(rid)
            if not req._event.is_set():
                req.respond(504, b'{"error": "serving timeout"}')
                # drop the dead exchange from routing so workers draining a
                # batch skip it (its _event is set; _process filters those)
                # instead of scoring into a 504'd socket
                with self.serving._lock:
                    self.serving._routing.pop(rid, None)

    def _close(self, conn):
        conn.closed = True
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        for req in conn.inflight:
            self._deadlines.pop(req.id, None)

    def shutdown(self):
        self._stop.set()
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass

    def server_close(self):
        for key in list(self._sel.get_map().values()):
            try:
                key.fileobj.close()
            except OSError:
                pass
        self._sel.close()


class _PartitionQueue:
    """Condition-variable request queue with latency-budget coalescing.

    Replaces the fixed-poll `queue.Queue` drain: a worker blocked in
    `drain()` is woken the instant `put()` lands — an idle partition adds
    ZERO polling latency to the first request (reference: the continuous
    WorkerServer path hands requests straight to the pinned pipeline).
    After the first request, `linger_s` is the
    latency budget: the drain coalesces whatever else arrives within it
    (up to max_rows) instead of either returning a batch of one or
    sleeping a fixed poll interval."""

    __slots__ = ("_items", "_cond")

    def __init__(self):
        self._items = collections.deque()
        self._cond = threading.Condition()

    def put(self, req) -> None:
        with self._cond:
            self._items.append(req)
            self._cond.notify()

    def qsize(self) -> int:
        return len(self._items)   # racy read: load-shed bound, not invariant

    def drain(self, max_rows: int, idle_timeout: float,
              linger_s: float = 0.0) -> list:
        """Up to max_rows requests: block at most idle_timeout for the
        first, then coalesce arrivals within linger_s. linger_s=0 takes
        exactly what is already queued (continuous/drain-available)."""
        batch: list = []
        with self._cond:
            if not self._items:
                self._cond.wait(idle_timeout)
                if not self._items:
                    return batch
            while self._items and len(batch) < max_rows:
                batch.append(self._items.popleft())
            if linger_s > 0.0 and len(batch) < max_rows:
                deadline = time.monotonic() + linger_s
                while len(batch) < max_rows:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0.0:
                        break
                    if not self._items:
                        self._cond.wait(remaining)
                    while self._items and len(batch) < max_rows:
                        batch.append(self._items.popleft())
        return batch


class ServingServer:
    """Per-host HTTP ingress with N logical partitions and epoch replay
    (reference: WorkerServer + HTTPSourceStateHolder, HTTPSourceV2.scala)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 num_partitions: int = 1, reply_timeout: float = 30.0,
                 transport: str = "selector", max_queue: int = 1024,
                 faults: Optional[FaultInjector] = None,
                 admission=None):
        if transport not in ("selector", "threading"):
            raise ValueError("transport must be selector|threading")
        self.num_partitions = num_partitions
        self.reply_timeout = reply_timeout
        # load shedding bound: a partition queue beyond this answers 503
        # immediately instead of growing without bound (heavy-traffic
        # ingress must fail fast, not queue into certain 504s)
        self.max_queue = max_queue
        # burn-aware admission controller (control/actuators.py): when the
        # error budget is burning, shed-before-queue with Retry-After
        # (None = admit everything up to max_queue)
        self.admission = admission
        # deterministic fault injection (None = zero-overhead disabled);
        # falls back to the MMLSPARK_TPU_FAULTS env spec
        self._faults = faults if faults is not None else FaultInjector.from_env()
        self._draining = False
        # set by io.registry.start_distributed_serving: takes this
        # server's entry out of the registry; stop() calls it first
        self._leave_registry = None
        self._queues = [_PartitionQueue() for _ in range(num_partitions)]
        self._rr = itertools.count()
        # (partition, epoch) -> list[CachedRequest]; GC'd on commit
        self._history: dict = {}
        self._epochs = [0] * num_partitions
        self._routing: dict = {}  # request id -> CachedRequest
        self._lock = threading.Lock()
        if transport == "selector":
            self._httpd = _SelectorServer((host, port), self)
        else:
            self._httpd = _ThreadingServer((host, port), _Handler)
            self._httpd.serving = self  # type: ignore
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ServingServer":
        self._thread.start()
        return self

    def stop(self, drain: bool = True, drain_timeout: float = 5.0):
        """Graceful drain then shutdown: new connections are refused and
        new requests answered 503, in-flight exchanges are answered and
        flushed (bounded by `drain_timeout`), THEN the transport dies.
        `drain=False` is the old hard stop. A server that a registry
        lists leaves it first, so clients stop routing to it."""
        leave, self._leave_registry = self._leave_registry, None
        if leave is not None:
            leave()
        self._draining = True
        if drain:
            stop_accepting = getattr(self._httpd, "stop_accepting", None)
            if stop_accepting is not None:
                stop_accepting()
            pending = getattr(self._httpd, "pending_exchanges", None)
            deadline = time.monotonic() + drain_timeout
            while time.monotonic() < deadline:
                if pending is not None:
                    busy = pending()
                else:
                    with self._lock:
                        busy = any(not r._event.is_set()
                                   for r in self._routing.values())
                if not busy:
                    break
                time.sleep(0.01)
        self._httpd.shutdown()
        # join the loop thread BEFORE closing fds: the selector loop may
        # be inside select()/recv(), and closing the epoll fd under it
        # raises in the serving thread (the stdlib server's shutdown()
        # blocks internally; the selector server's does not)
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        self._httpd.server_close()

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def _metrics_response(self, path: str) -> tuple:
        """(status, payload, content_type) for the exposition GETs —
        /metrics, /metrics.json[?window=N], /slo, /quality, /versions,
        /debug/bundle, /debug/profile?ms=N — over the process-wide
        registry, SLO engine, flight recorder and profile session
        (telemetry.exposition; mounted on both transports). `path` keeps
        its query string."""
        from ..telemetry.exposition import metrics_http_response
        return metrics_http_response(path)

    def _start_request_span(self, req: CachedRequest):
        """Ingress root span. A fresh trace uses the REQUEST ID as the
        trace id — the id the client reads back in `X-Request-Id` is then
        the trace id AND the root span id, one id everywhere. An incoming
        `X-Trace-Id` header joins its trace instead (the request id still
        names the root span within it)."""
        tracer = get_tracer()
        headers = req.headers
        tracing_off = (tracer.sample_rate <= 0.0
                       and tracer.tail_latency_ms is None)
        if (tracing_off
                and TRACE_HEADER not in headers
                and "x-trace-id" not in headers
                and "X-trace-id" not in headers):
            # disabled fast path: three dict membership tests covering the
            # spellings real clients send (exact, selector-lowercased,
            # urllib-capitalized) — extract()'s per-key scan was measurable
            # at ingress rates. Exotic casings only join when sampling is
            # on. Tail capture keeps the slow path live: an unsampled
            # request must still record tentatively so a breach can
            # promote its full tree.
            return None
        ctx = tracer.extract(headers)
        if ctx is None and tracing_off:
            return None
        return tracer.start_span(
            tnames.SERVING_REQUEST_SPAN, parent=ctx,
            trace_id=None if ctx is not None else req.id,
            span_id=req.id, attrs={"path": req.path})

    # -- ingress ------------------------------------------------------------
    def _enqueue(self, req: CachedRequest):
        # every real ingress request counts — shed and timed-out ones
        # included (they're the SLO denominator); exposition self-scrapes
        # never reach _enqueue on either transport, so /metrics pollers
        # can't inflate traffic counts or error rates
        req.slo = True
        reliability_metrics.inc(tnames.SERVING_REQUEST_TOTAL)
        req.span = self._start_request_span(req)
        if self._draining:
            # drain: in-flight work finishes, NEW work is refused
            reliability_metrics.inc(tnames.SERVING_SHED_REQUESTS)
            req.respond(503, b'{"error": "server draining"}')
            return
        pid = next(self._rr) % self.num_partitions
        admission = self.admission
        if admission is not None \
                and admission.should_shed(self._queues[pid].qsize()):
            # burn-aware shed-BEFORE-queue: while the error budget burns,
            # a request that would have to wait behind queued work is
            # refused immediately with Retry-After — queueing it would
            # spend budget on a reply that arrives late anyway, and the
            # explicit back-off is what lets the fleet recover
            reliability_metrics.inc(tnames.SERVING_SHED_REQUESTS)
            reliability_metrics.inc(tnames.CONTROL_ADMISSION_SHED)
            req.retry_after = admission.retry_after_s
            req.respond(503, b'{"error": "error budget burning"}')
            return
        if self.max_queue and self._queues[pid].qsize() >= self.max_queue:
            # load shedding: a queue past the bound means every enqueued
            # request is already doomed to time out — shed NOW with 503 so
            # clients back off instead of piling onto a 504 cliff
            reliability_metrics.inc(tnames.SERVING_SHED_REQUESTS)
            req.respond(503, b'{"error": "overloaded"}')
            return
        req.t_enqueue = time.perf_counter()
        with self._lock:
            self._routing[req.id] = req
        q = self._queues[pid]
        q.put(req)
        reliability_metrics.set_gauge(tnames.SERVING_QUEUE_DEPTH, q.qsize())

    # -- source API (per-partition readers) ---------------------------------
    def get_batch(self, pid: int, max_rows: int = 64,
                  timeout: float = 0.05, linger: float = 0.0) -> tuple:
        """Drain up to max_rows requests for partition pid; returns
        (epoch, [CachedRequest]). Replayed batches take priority — a worker
        re-registering at an uncommitted epoch sees the same data again
        (reference: registerPartition recovery, HTTPSourceV2.scala:488-505).

        `timeout` bounds the idle wait for the FIRST request (the worker
        loop's stop-flag check cadence); the wakeup itself is a condition
        variable, not a poll. `linger` is the coalescing latency budget in
        SECONDS: once one request is in hand, arrivals within the budget
        join the batch up to max_rows (0.0 = take only what is already
        queued — continuous mode's batch-of-1 takes the first request
        immediately either way)."""
        with self._lock:
            epoch = self._epochs[pid]
            cached = self._history.get((pid, epoch))
        if cached is not None:
            # filter requests already answered (client may have timed out)
            alive = [r for r in cached if not r._event.is_set()]
            return epoch, alive
        batch = self._queues[pid].drain(max_rows, timeout, linger)
        if batch:
            now = time.perf_counter()
            # one registry lookup per batch (NOT per request); the handle is
            # never cached across calls so tests' reset() stays effective.
            # trace_id leaves a per-bucket exemplar: the request id IS the
            # trace id, so a slow queue bucket points at a followable trace
            hist = reliability_metrics.histogram(tnames.SERVING_REQUEST_QUEUE)
            for r in batch:
                hist.observe_ms((now - r.t_enqueue) * 1000.0,
                                trace_id=r.id)
        with self._lock:
            self._history[(pid, epoch)] = batch
        return epoch, batch

    def commit(self, epoch: int, pid: int):
        """Epoch commit: GC history and advance (HTTPSourceV2.scala:555-567)."""
        with self._lock:
            batch = self._history.pop((pid, epoch), []) or []
            for r in batch:
                self._routing.pop(r.id, None)
            self._epochs[pid] = epoch + 1

    # -- sink API -----------------------------------------------------------
    def reply_to(self, request_id: str, data, status: int = 200,
                 content_type: Optional[str] = None,
                 version: Optional[str] = None):
        """Route a response to the held exchange (HTTPSourceV2.scala:535-553).
        `content_type` overrides the type inferred from `data` — the fast
        path hands over preserialized JSON bytes and must not label them
        octet-stream. `version` stamps the reply's `X-Model-Version`
        header: the ModelVersion that DEQUEUED and scored this request,
        which a hot-swap mid-flight does not rewrite."""
        with self._lock:
            req = self._routing.get(request_id)
        if req is None:
            return False
        if isinstance(data, bytes):
            payload, ctype = data, "application/octet-stream"
        elif isinstance(data, str):
            payload, ctype = data.encode(), "text/plain"
        else:
            payload, ctype = json.dumps(_jsonable(data)).encode(), "application/json"
        if version is not None:
            req.version = version
        req.respond(status, payload, content_type or ctype)
        return True


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.integer, np.floating, np.bool_)):
        return v.item()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


class ServingQuery:
    """Streaming engine stand-in: per-partition worker threads pulling
    batches through a model and replying (reference: the executor-local
    request->pipeline->reply path, SURVEY.md §3.4)."""

    def __init__(self, server: ServingServer, transform_fn: Callable,
                 mode: str = "microbatch", max_batch: int = 64,
                 poll_timeout: float = 0.02, batch_linger_ms: float = 0.0,
                 faults: Optional[FaultInjector] = None,
                 watchdog_interval: float = 0.02):
        if mode not in ("microbatch", "continuous"):
            raise ValueError("mode must be microbatch|continuous")
        if batch_linger_ms < 0:
            raise ValueError("batch_linger_ms must be >= 0")
        self.server = server
        self.transform_fn = transform_fn
        self.max_batch = 1 if mode == "continuous" else max_batch
        self.poll_timeout = poll_timeout
        # coalescing latency budget: 0 drains only what is already queued
        # (and continuous mode's batch-of-1 never lingers — the first
        # request dispatches immediately); >0 trades that much tail
        # latency for batch occupancy under load
        self.batch_linger_ms = 0.0 if mode == "continuous" \
            else float(batch_linger_ms)
        self.watchdog_interval = watchdog_interval
        # share the server's injector by default: one seed, one schedule
        self._faults = faults if faults is not None else server._faults
        self._stop = threading.Event()
        self._threads: list = []
        self._watchdog: Optional[threading.Thread] = None
        self._errors: list = []
        self._inject: set = set()  # partitions poisoned by inject_fault
        self._recoveries = 0
        self._restarts = 0

    def start(self) -> "ServingQuery":
        for pid in range(self.server.num_partitions):
            th = threading.Thread(target=self._work, args=(pid,), daemon=True)
            th.start()
            self._threads.append(th)
        # watchdog: a worker thread that DIES (an InjectedCrash, a segfaulted
        # extension, an unforeseen escape) is restarted; the uncommitted
        # epoch replays to the fresh worker (reference: registerPartition
        # recovery, HTTPSourceV2.scala:488-505)
        self._watchdog = threading.Thread(target=self._watch, daemon=True)
        self._watchdog.start()
        return self

    def _watch(self):
        while not self._stop.wait(self.watchdog_interval):
            for pid, th in enumerate(self._threads):
                if th.is_alive() or self._stop.is_set():
                    continue
                self._restarts += 1
                reliability_metrics.inc(tnames.SERVING_WORKER_RESTARTS)
                fresh = threading.Thread(target=self._work, args=(pid,),
                                         daemon=True)
                self._threads[pid] = fresh
                fresh.start()

    MAX_REPLAYS = 3  # per epoch; then the batch is failed out (502) and
    # committed so one poison request can't wedge its partition forever

    def _work(self, pid: int):
        replays = 0
        while not self._stop.is_set():
            batch: list = []
            try:
                epoch, batch = self.server.get_batch(
                    pid, self.max_batch, timeout=self.poll_timeout,
                    linger=self.batch_linger_ms / 1000.0)
                if pid in self._inject and batch:
                    # die between read and commit — the worst spot: requests
                    # are in flight. History must replay them to the next
                    # attempt (reference: HTTPv2Suite "fault tolerance" :329).
                    self._inject.discard(pid)
                    raise RuntimeError("injected worker death")
                if self._faults is not None and batch:
                    # seeded faults at the same worst spot; only non-empty
                    # reads advance the site counter so the schedule is
                    # deterministic for a serialized request stream
                    self._faults.perturb("serving.worker")
                if not batch:
                    self.server.commit(epoch, pid)
                    continue
                self._process(pid, epoch, batch)
                self.server.commit(epoch, pid)
                replays = 0
            except InjectedCrash:
                # injected worker DEATH: the thread exits with the epoch
                # uncommitted — the watchdog restarts it and history replays
                # the in-flight batch to the fresh worker. (return, not
                # raise: an intentional death shouldn't spray a traceback)
                self._recoveries += 1
                if batch:
                    reliability_metrics.inc(tnames.SERVING_REPLAYED_EPOCHS)
                return
            except Exception as e:  # noqa: BLE001 - worker survives task errors
                if len(self._errors) < 1000:
                    self._errors.append(e)
                self._recoveries += 1
                replays += 1
                if batch:
                    reliability_metrics.inc(tnames.SERVING_REPLAYED_EPOCHS)
                if batch and replays > self.MAX_REPLAYS:
                    # poison batch: isolate the poison ROW instead of
                    # failing everyone — retry each request individually so
                    # only the request(s) that actually break get a 502
                    # (reference: ServingUDFs' row-level errorCol
                    # short-circuit)
                    for r in batch:
                        if r._event.is_set():
                            continue  # already answered (expired to 504)
                        try:
                            reply = self._transform([r])[0]
                            self._reply_one(r, reply)
                        except Exception as row_e:  # noqa: BLE001
                            self.server.reply_to(r.id, {"error": str(row_e)},
                                                 status=502)
                    self.server.commit(epoch, pid)
                    replays = 0
                else:
                    # no commit -> epoch unchanged -> history replays;
                    # brief backoff so a failing loop doesn't hot-spin
                    time.sleep(0.01 * replays)

    def _transform(self, live: list) -> list:
        """Run the transform over a batch of CachedRequests. A transform
        that declares `wants_request_ids` (the compiled fast path,
        io/plan.py) also receives each row's request id — the id the
        client reads back as `X-Request-Id`, which keys the model-quality
        delayed-label join (telemetry/quality.py)."""
        bodies = [r.body for r in live]
        if getattr(self.transform_fn, "wants_request_ids", False):
            return self.transform_fn(bodies,
                                     request_ids=[r.id for r in live])
        return self.transform_fn(bodies)

    def _reply_one(self, r, reply):
        if isinstance(reply, Reply):
            self.server.reply_to(r.id, reply.data, status=reply.status,
                                 content_type=reply.content_type,
                                 version=reply.version)
        else:
            self.server.reply_to(r.id, reply)

    def _process(self, pid: int, epoch: int, batch: list):
        # skip exchanges already answered (expired to 504 by the transport):
        # the transform would be wasted compute into a dead socket
        live = [r for r in batch if not r._event.is_set()]
        if not live:
            return
        reliability_metrics.set_gauge(tnames.SERVING_BATCH_OCCUPANCY,
                                      len(live) / max(self.max_batch, 1))
        # trace context rides into the transform: nested spans (the
        # compiled-plan run in io/plan.py, downstream RegistryClient posts)
        # attach under the batch's FIRST sampled request — a coalesced
        # batch shares one execution, so it shares one ambient parent
        tracer = get_tracer()
        parent = next((r.span for r in live if r.span is not None), None)
        t0 = time.perf_counter()
        if parent is not None:
            with tracer.use(parent):
                replies = self._transform(live)
        else:
            replies = self._transform(live)
        t1 = time.perf_counter()
        if parent is not None:
            # one transform span PER SAMPLED REQUEST (each parented to its
            # own ingress span, so every trace shows its worker hop), all
            # stamped with the shared batch duration
            dur_ms = (t1 - t0) * 1000.0
            for r in live:
                if r.span is not None:
                    tracer.record(tnames.SERVING_PARTITION_TRANSFORM_SPAN,
                                  parent=r.span, duration_ms=dur_ms,
                                  attrs={"partition": pid, "epoch": epoch,
                                         "batch": len(live)})
        for r, reply in zip(live, replies):
            self._reply_one(r, reply)
        t2 = time.perf_counter()
        # stage latencies: transform/reply are per-BATCH (every request in
        # the batch experienced them); e2e is per request from ingress
        # enqueue to routed response
        reliability_metrics.observe_ms(tnames.SERVING_REQUEST_TRANSFORM,
                                       (t1 - t0) * 1000.0)
        reliability_metrics.observe_ms(tnames.SERVING_REQUEST_REPLY,
                                       (t2 - t1) * 1000.0)
        hist = reliability_metrics.histogram(tnames.SERVING_REQUEST_E2E)
        for r in live:
            # exemplar: a burning e2e p99 bucket resolves to this request
            # id == trace id == the tail-captured span tree (perf.py)
            hist.observe_ms((t2 - r.t_enqueue) * 1000.0, trace_id=r.id)

    def stop(self):
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)
        for th in self._threads:
            th.join(timeout=5)

    def inject_fault(self, pid: int):
        """Fault injection for tests: the next batch read on `pid` dies
        mid-flight; epoch replay must redeliver it (WorkerServer
        registerPartition recovery, HTTPSourceV2.scala:488-505)."""
        self._inject.add(pid)


def serve_pipeline(model, input_cols, output_col: str = "prediction",
                   host: str = "127.0.0.1", port: int = 0,
                   num_partitions: int = 1, mode: str = "microbatch",
                   max_batch: int = 64, batch_linger_ms: float = 0.0,
                   fast_path: bool = True, faults=None, admission=None):
    """One-call serving of a fitted PipelineModel: JSON rows in, scored
    column out (reference: the readStream.server().load() ->
    pipeline -> writeStream.server() composition, IOImplicits.scala).

    Each request body is a JSON object {col: value, ...}; the reply is
    {output_col: value}. Returns (server, query); stop with query.stop() +
    server.stop().

    `fast_path=True` (default) runs the compiled transform (io/plan.py):
    per-(fingerprint, shape-bucket) cached plans, GBDT on its prebuilt
    host plan, card stages through their `transform` at power-of-two
    buckets, one columnar decode per batch, per-row 400s for malformed
    rows, preserialized reply framing. `fast_path=False` keeps the
    uncached Table-per-batch path: every batch decodes its bodies, builds
    a `Table` of `input_cols` and calls `model.transform` (the baseline
    the fast path is measured against), with the fast path's per-row 400s
    for malformed bodies and for values the model refuses. `batch_linger_ms` is the
    microbatch coalescing budget. `faults` arms the transform's
    `serving.swap` chaos site (a mid-`install_model` fault rolls back to
    the incumbent); hot-swap a retrained model with
    `query.transform_fn.install_model(new_model)`, with zero dropped
    requests. `admission` mounts a burn-aware admission controller
    (`control.actuators.BurnAwareAdmission`) on the server: while the
    error budget burns, excess load is shed with 503 + Retry-After."""
    if fast_path:
        from .plan import compile_serving_transform
        transform = compile_serving_transform(model, input_cols, output_col,
                                              faults=faults)
    else:
        import torch

        from ..core import Table
        from .plan import _decode_rows, _host_values

        def score(rows: list) -> list:
            cols = {c: np.asarray([row[c] for row in rows])
                    for c in input_cols}
            # grad mode is per thread: the worker's forward enters no_grad
            with torch.no_grad():
                out = model.transform(Table(cols))
            return [{output_col: _jsonable(v)}
                    for v in _host_values(out[output_col])]

        def transform(bodies: list) -> list:
            # the fast path's client rules: a malformed body, or a value
            # the model refuses on its own row, answers 400 alone
            rows, replies = _decode_rows(bodies, input_cols)
            good = [i for i, r in enumerate(rows) if r is not None]
            if not good:
                return replies
            try:
                for i, rep in zip(good, score([rows[i] for i in good])):
                    replies[i] = rep
            except (ValueError, TypeError):
                for i in good:
                    try:
                        replies[i] = score([rows[i]])[0]
                    except (ValueError, TypeError) as e:
                        replies[i] = Reply({"error": f"bad request: {e}"},
                                           status=400)
            return replies

    server = ServingServer(host, port, num_partitions,
                           admission=admission).start()
    q = ServingQuery(server, transform, mode=mode, max_batch=max_batch,
                     batch_linger_ms=batch_linger_ms).start()
    return server, q


def drain_on_signal(servers=(), queries=(), registries=(), signals=None,
                    exit_code: int = 0, drain_timeout: float = 5.0):
    """Route SIGTERM (host preemption) through the graceful drain path.

    A preempted serving host must not die with in-flight requests
    unanswered. This installs a handler that, on SIGTERM/SIGINT: refuses
    new connections and 503s new requests on every server while
    in-flight exchanges are ANSWERED and flushed
    (`ServingServer.stop(drain=True)`), then stops the queries, then the
    registries (`io.registry.ServiceRegistry`, the leader's), and finally
    exits with `exit_code` (SystemExit; pass `exit_code=None` to keep the
    process alive). Counted under `serving.signal_drains`. Must be called
    from the main thread; returns the handler so tests can invoke it
    directly.
    """
    import signal as _signal
    servers, queries = tuple(servers), tuple(queries)
    registries = tuple(registries)
    if signals is None:
        signals = (_signal.SIGTERM, _signal.SIGINT)

    def _handler(signum=_signal.SIGTERM, frame=None):
        reliability_metrics.inc(tnames.SERVING_SIGNAL_DRAINS)
        # order matters: servers drain FIRST (workers must still be alive
        # to answer the in-flight requests), then queries, then registries
        for s in servers:
            try:
                s.stop(drain=True, drain_timeout=drain_timeout)
            except Exception:  # noqa: BLE001 - drain the rest regardless
                pass
        for q in queries:
            try:
                q.stop()
            except Exception:  # noqa: BLE001
                pass
        for r in registries:
            try:
                r.stop()
            except Exception:  # noqa: BLE001
                pass
        if exit_code is not None:
            raise SystemExit(exit_code)

    for sig in signals:
        _signal.signal(sig, _handler)
    return _handler
