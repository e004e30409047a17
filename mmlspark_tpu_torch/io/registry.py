"""Cross-process serving registry: every process serves, a leader knows
them all.

Port of the reference's `io/registry.py` (which imports no JAX): the
leader (process 0 of the job `parallel.cluster.initialize_cluster`
formed) runs `ServiceRegistry`; every process reports its
`ServingServer` with `report_server_to_registry`; a `RegistryClient`
round-robins requests over the live servers and fails a dead one over.
The wire format is the reference's, so a client of either package talks
to a registry of the other.

Composition (see `start_distributed_serving`):

    process 0:  ServiceRegistry (HTTP)  <- register/unregister/list
    process k:  ServingServer + ServingQuery, reports its ServiceInfo
    clients:    RegistryClient.post(...) round-robins across live servers,
                dropping dead ones from rotation (LB failover semantics)
"""
from __future__ import annotations

import functools
import http.client
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler
from typing import NamedTuple, Optional

from ..reliability.metrics import reliability_metrics
from ..reliability.policy import RetryPolicy
from ..telemetry.spans import get_tracer
from ..telemetry import names as tnames
from .serving import EXPOSITION_PATHS, _ThreadingServer


class ServiceInfo(NamedTuple):
    """One registered server (reference: ServiceInfo, HTTPSourceV2.scala:460).

    `kind` says what the endpoint IS — ``"serving"`` (a ServingServer
    answering inference traffic) or ``"trainer"`` (a training process's
    metrics/slo exposition surface, `telemetry.exposition.expose_trainer`)
    — so `scrape_cluster`/`TelemetryPoller` can target one class without
    probing. Wire compat: a ``"serving"`` register omits the field (the
    pre-kind body byte-for-byte) and a missing field parses as serving.

    `version` is the model version id the worker was serving when it
    registered (`ServingTransform.version`, telemetry/lineage.py) — the
    coarse rollout map. It is a REGISTRATION
    snapshot, not live state — a hot-swap after registration shows in
    `/versions`, not here. Same wire contract as `kind`: None omits the
    field (version-less body byte-for-byte) and a missing field parses
    as None."""
    name: str
    host: str
    port: int
    process_id: int
    num_partitions: int
    kind: str = "serving"
    version: Optional[str] = None

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"


class _RegistryHandler(BaseHTTPRequestHandler):
    server_version = "mmlspark_tpu-registry/1.0"

    def _json(self, status: int, obj):
        payload = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_POST(self):  # noqa: N802
        length = int(self.headers.get("Content-Length", 0))
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except ValueError:
            return self._json(400, {"error": "bad json"})
        reg: "ServiceRegistry" = self.server.registry  # type: ignore
        # trace propagation terminus: a RegistryClient/worker post carrying
        # X-Trace-Id lands its registry hop in the same trace
        tracer = get_tracer()
        ctx = tracer.extract(dict(self.headers))
        if ctx is not None and ctx.sampled:
            tracer.record("registry" + self.path.replace("/", "."),
                          parent=ctx, kind="event")
        if self.path == "/register":
            try:
                info = ServiceInfo(**body)
            except TypeError as e:
                return self._json(400, {"error": str(e)})
            reg._put(info)
            return self._json(200, {"registered": info.address})
        if self.path == "/unregister":
            if not isinstance(body, dict):
                return self._json(400, {"error": "body must be an object"})
            reg._remove(body.get("name", ""), body.get("host", ""),
                        body.get("port", 0))
            return self._json(200, {"ok": True})
        return self._json(404, {"error": f"unknown path {self.path}"})

    def do_GET(self):  # noqa: N802
        reg: "ServiceRegistry" = self.server.registry  # type: ignore
        path = self.path.split("?", 1)[0]
        if path in EXPOSITION_PATHS:
            # full path rides through so ?window= reaches the handler;
            # /quality and /versions export the leader's own state
            # (worker exports come from scrape_cluster); the paths the
            # port does not answer yet say 501 naming their item
            from ..telemetry.exposition import metrics_http_response
            status, payload, ctype = metrics_http_response(self.path)
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
            return
        if self.path.startswith("/services/"):
            name = self.path[len("/services/"):]
            return self._json(200, [i._asdict() for i in reg.services(name)])
        if self.path == "/services":
            return self._json(200, [i._asdict() for i in reg.services()])
        return self._json(404, {"error": f"unknown path {self.path}"})

    def log_message(self, *args):  # quiet
        pass


class ServiceRegistry:
    """The leader-side registry service (DriverServiceUtils analog).

    `ttl_s` arms stale-entry expiry: every registration (a worker's
    periodic re-`report_server_to_registry` IS its heartbeat) refreshes
    the entry's `last_seen` stamp, and an entry not refreshed within
    `ttl_s` is evicted on the next read (`registry.evictions`) — the
    routing tier never weighs a worker that stopped heartbeating. The
    default (None) keeps the legacy forever-registration, and the WIRE
    is unchanged either way: a TTL-less client's registration body still
    parses (expiry is registry-side state, not a protocol field)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 ttl_s: Optional[float] = None, clock=time.monotonic):
        self.ttl_s = ttl_s
        self._clock = clock
        self._services: dict = {}   # (name, host, port) -> ServiceInfo
        self._last_seen: dict = {}  # (name, host, port) -> clock() stamp
        self._lock = threading.Lock()
        self._httpd = _ThreadingServer((host, port), _RegistryHandler)
        self._httpd.registry = self  # type: ignore
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)

    def start(self) -> "ServiceRegistry":
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        # shutdown() returns once serve_forever exits, but the thread may
        # still be unwinding — join so tests don't leak daemon threads
        # between scenarios
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def _put(self, info: ServiceInfo):
        with self._lock:
            key = (info.name, info.host, info.port)
            self._services[key] = info
            # re-registration refreshes the heartbeat stamp: the SAME
            # (name, host, port) posting again is a liveness signal,
            # not a new worker
            self._last_seen[key] = self._clock()

    def _remove(self, name: str, host: str, port: int):
        with self._lock:
            self._services.pop((name, host, port), None)
            self._last_seen.pop((name, host, port), None)

    def _evict_stale(self):
        """TTL expiry at read time (no sweeper thread: a registry nobody
        reads has nobody to mislead). One eviction counted per entry."""
        if self.ttl_s is None:
            return
        now = self._clock()
        with self._lock:
            stale = [k for k, seen in self._last_seen.items()
                     if now - seen > self.ttl_s]
            for key in stale:
                self._services.pop(key, None)
                self._last_seen.pop(key, None)
        for _ in stale:
            reliability_metrics.inc(tnames.REGISTRY_EVICTIONS)

    def services(self, name: Optional[str] = None):
        self._evict_stale()
        with self._lock:
            vals = list(self._services.values())
        return [v for v in vals if name is None or v.name == name]


def report_server_to_registry(registry_address: str, name: str, host: str,
                              port: int, process_id: int = 0,
                              num_partitions: int = 1,
                              timeout: float = 10.0,
                              retry_policy: Optional[RetryPolicy] = None,
                              kind: str = "serving",
                              version: Optional[str] = None) -> None:
    """Worker-side report (WorkerClient.reportServerToDriver,
    HTTPSourceV2.scala:460-468).

    Connection failures retry with jittered backoff under `timeout` as the
    overall deadline (reliability.RetryPolicy): a worker that comes up
    before the leader's registry is listening keeps trying instead of
    failing registration permanently. An HTTP error status does NOT retry
    — the registry answered and said no."""
    policy = retry_policy if retry_policy is not None else RetryPolicy(
        max_attempts=32, backoff=0.05, backoff_factor=2.0, max_backoff=1.0,
        jitter=0.25, deadline=timeout,
        metric_name=tnames.REGISTRY_REPORT_RETRIES)
    info = ServiceInfo(name=name, host=host, port=port,
                       process_id=process_id,
                       num_partitions=num_partitions, kind=kind,
                       version=version)
    body = info._asdict()
    if body["kind"] == "serving":
        # wire compat (the satellite contract): the default kind posts
        # the pre-kind body byte-for-byte; only trainers say so
        body.pop("kind")
    if body["version"] is None:
        # same contract for version: an unversioned register posts the
        # pre-version body byte-for-byte
        body.pop("version")
    data = json.dumps(body).encode()
    last_err: Optional[Exception] = None
    headers = get_tracer().inject({"Content-Type": "application/json"})
    for att in policy.attempts():
        req = urllib.request.Request(
            registry_address + "/register", data=data,
            headers=headers, method="POST")
        try:
            with urllib.request.urlopen(
                    req, timeout=att.timeout(5.0) or 5.0) as resp:
                if resp.status != 200:
                    raise RuntimeError(
                        f"registry refused registration: {resp.status}")
                return
        except urllib.error.HTTPError:
            raise   # a real answer from a live registry; retrying can't help
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            last_err = e
            att.retry()
    raise RuntimeError(
        f"registry registration failed after retries: {last_err}") \
        from last_err


def list_services(registry_address: str, name: str,
                  timeout: float = 10.0) -> list:
    with urllib.request.urlopen(registry_address + f"/services/{name}",
                                timeout=timeout) as resp:
        return [ServiceInfo(**d) for d in json.loads(resp.read())]


class RegistryClient:
    """Round-robin client over every registered server of a service — the
    load-balancer role the reference's ServiceInfo export feeds. Dead
    servers drop out of rotation (and are retried on the next refresh).

    Connections are POOLED keep-alive `http.client` sockets, one per
    (thread, server): the pre-overhaul urllib path paid a fresh TCP
    handshake per post — at serving rates that handshake dominates the
    request itself. Pools are thread-local so concurrent callers never
    serialize on a shared socket; dead-server eviction is shared. A reused
    socket the server idle-closed between posts gets ONE transparent
    reconnect to the same server before the failure counts against it
    (at-least-once semantics, same as the failover re-execution the
    rotation already implies)."""

    _MAX_ATTEMPTS = 16  # failover ceiling per post()

    def __init__(self, registry_address: str, name: str,
                 refresh_every: int = 64, timeout: float = 30.0):
        self.registry_address = registry_address
        self.name = name
        self.timeout = timeout
        self._refresh_every = max(refresh_every, 1)
        self._lock = threading.Lock()
        self._targets: list = []
        self._dead: set = set()
        self._count = 0
        self._local = threading.local()   # per-thread address -> conn
        self.refresh()

    # -- connection pool -----------------------------------------------------
    def _pool(self) -> dict:
        pool = getattr(self._local, "pool", None)
        if pool is None:
            pool = self._local.pool = {}
        return pool

    def _conn_for(self, t: ServiceInfo):
        pool = self._pool()
        conn = pool.get(t.address)
        if conn is None:
            conn = pool[t.address] = http.client.HTTPConnection(
                t.host, t.port, timeout=self.timeout)
        return conn

    def _drop_conn(self, address: str) -> None:
        conn = self._pool().pop(address, None)
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        """Close THIS thread's pooled connections (each thread owns its
        pool; sockets also die with the process — daemon client threads
        need no explicit close)."""
        pool = self._pool()
        for addr in list(pool):
            self._drop_conn(addr)

    def _post_target(self, t: ServiceInfo, path: str, body: bytes,
                     content_type: str):
        """One POST over the pooled connection. A failure on a REUSED
        socket (stale keep-alive: the server closed it between posts)
        retries once on a fresh connection to the same server; a fresh
        connection's failure propagates to the failover loop."""
        # active sampled trace context propagates (X-Trace-Id) so the
        # receiving server's ingress span joins THIS trace; inject() is a
        # contextvar read when no trace is active
        headers = get_tracer().inject({"Content-Type": content_type})
        for _ in range(2):
            conn = self._conn_for(t)
            reused = conn.sock is not None
            try:
                conn.request("POST", path, body=body, headers=headers)
                resp = conn.getresponse()
                return resp.status, resp.read()
            except (http.client.HTTPException, ConnectionError, OSError):
                self._drop_conn(t.address)
                if not reused:
                    raise
        raise ConnectionError("unreachable")  # loop always returns/raises

    def refresh(self):
        targets = list_services(self.registry_address, self.name,
                                timeout=self.timeout)
        with self._lock:
            self._targets = targets
            self._dead.clear()

    def _next_target(self):
        """Pick the next live target; None when every target is dead."""
        with self._lock:
            live = [t for t in self._targets if t.address not in self._dead]
            if not live:
                return None
            t = live[self._count % len(live)]
            self._count += 1
            return t

    def post(self, body: bytes, path: str = "/",
             content_type: str = "application/json"):
        """POST to the next live server over its pooled keep-alive
        connection. Only CONNECTION failures fail the server over — an
        HTTP error status (e.g. serving's row-level 502) is a real answer
        from a healthy server and is returned as-is; failing over on it
        would re-execute the request elsewhere."""
        if self._count and self._count % self._refresh_every == 0:
            try:
                self.refresh()
            except Exception:  # noqa: BLE001 - keep serving from last list
                pass
        # bounded attempts rather than a pre-computed live count (marking a
        # server dead changes the rotation mid-call); at most ONE all-dead
        # registry re-poll per post — re-polling every iteration would
        # resurrect a crashed-but-still-registered server 16 times and turn
        # one dead host into minutes of connect timeouts
        last_err = None
        refreshed = False
        for _ in range(self._MAX_ATTEMPTS):
            t = self._next_target()
            if t is None:
                if refreshed:
                    break
                refreshed = True
                try:
                    self.refresh()   # a re-registered server re-enters here
                except Exception as e:  # noqa: BLE001
                    last_err = last_err or e
                    break
                t = self._next_target()
                if t is None:
                    break
            try:
                return self._post_target(t, path, body, content_type)
            except (http.client.HTTPException, ConnectionError, OSError) as e:
                last_err = e
                with self._lock:
                    self._dead.add(t.address)
        if last_err is None:
            raise RuntimeError(
                f"no live servers for service {self.name!r} "
                f"(registry {self.registry_address})")
        raise RuntimeError(f"every server for {self.name!r} failed: {last_err}")


def _unregister(registry_address: str, name: str, host: str, port: int,
                timeout: float = 5.0) -> bool:
    """Take one server's entry out of the registry (its `/unregister`).
    Best effort: a registry that is gone or answers an error leaves the
    entry to the clients' failover and the TTL. True when it was taken
    out."""
    req = urllib.request.Request(
        registry_address + "/unregister", method="POST",
        data=json.dumps({"name": name, "host": host, "port": port}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status == 200
    except (urllib.error.URLError, http.client.HTTPException, OSError):
        return False


def _advertised_host(bind_host: str, advertise_host) -> str:
    """The address other machines should dial. A wildcard/loopback bind is
    reachable only locally — advertise the host's routable address instead
    (reference: DriverServiceUtils.getDriverHost resolves the Spark leader's
    non-loopback address for exactly this reason)."""
    import socket
    if advertise_host:
        return advertise_host
    if bind_host in ("0.0.0.0", "::", ""):
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"
    return bind_host


def start_distributed_serving(transform_fn, name: str = "serving",
                              host: str = "127.0.0.1",
                              num_partitions: int = 1,
                              mode: str = "microbatch",
                              registry_port: int = 0,
                              advertise_host=None):
    """Every process of the job serves; the leader also runs the registry.
    Returns (registry_or_None, server, query, registry_address) —
    registry is non-None only on process 0.

    The reference's distributed-serving design (HTTPSourceV2: every
    executor a WorkerServer, the Spark leader the registry): process 0
    (`cluster.process_index()`) starts `ServiceRegistry` and broadcasts
    its address to every process as a fixed-width 256-byte uint8 buffer
    (`cluster.broadcast_from_leader`, a CPU object broadcast under gloo),
    every process reports its `ServingServer`, and the start ends with
    `cluster.barrier`. Without a multi-process job the process is the
    leader and the broadcast and barrier are no-ops. External clients
    discover the servers through the registry (`RegistryClient`).

    The server leaves the registry when it stops: `server.stop()`, and so
    `serving.drain_on_signal(servers=[server])` on SIGTERM, unregisters
    its entry before draining, so clients stop routing to it at once
    rather than after their failover or the registry's TTL.
    """
    import numpy as np
    from ..parallel import cluster
    from .serving import ServingQuery, ServingServer

    pid = cluster.process_index()
    pub_host = _advertised_host(host, advertise_host)
    registry = None
    if pid == 0:
        registry = ServiceRegistry(host=host, port=registry_port).start()
        # broadcast the ROUTABLE address, not the bind address — a
        # wildcard/loopback bind would point every other host at itself
        addr = f"http://{pub_host}:{registry._httpd.server_address[1]}"
    else:
        addr = ""
    buf = np.zeros(256, np.uint8)
    raw = addr.encode()
    buf[:len(raw)] = np.frombuffer(raw, np.uint8)
    out = np.asarray(cluster.broadcast_from_leader(buf), np.uint8)
    registry_address = bytes(out[out != 0]).decode()

    server = ServingServer(host=host, port=0,
                           num_partitions=num_partitions).start()
    query = ServingQuery(server, transform_fn, mode=mode).start()
    s_port = server._httpd.server_address[1]
    # a compiled ServingTransform carries its model-version id — register
    # it so the fleet's rollout map starts from the registry itself
    report_server_to_registry(registry_address, name, pub_host, s_port,
                              process_id=pid, num_partitions=num_partitions,
                              version=getattr(transform_fn, "version", None))
    server._leave_registry = functools.partial(
        _unregister, registry_address, name, pub_host, s_port)
    cluster.barrier(f"serving_up_{name}")
    return registry, server, query, registry_address
