"""Serving load generator: N concurrent keep-alive HTTP clients against a
ServingServer, with latency bookkeeping.

Port of the reference's `io/loadgen.py` (stdlib only): the closed-loop
harness `chip_smoke.py`'s [serving] phase drives the port's server with.

A client NEVER aborts on a failed request: the pre-control-loop version
`return`ed out of the loop on the first non-2xx, which silently deflated
req/s and made "zero dropped requests during a rollback" unassertable (a
client that dies on the first shed 503 stops witnessing the recovery).
Every response is tallied per status in `n_by_status`, a failed `check`
is recorded and the loop continues, and a dead socket is reconnected —
the only requests missing from `n_by_status` are the transport failures
themselves (`n_sent - sum(n_by_status.values())` is the dropped count a
zero-drop assertion pins to 0).
"""
from __future__ import annotations

import http.client
import threading
import time
from typing import Callable, NamedTuple, Optional


class LoadResult(NamedTuple):
    req_per_sec: float
    p50_ms: float
    p99_ms: float
    n_ok: int           # responses that passed `check` (the latency set)
    errors: list        # transport failures AND failed-check exceptions
    latencies_s: list   # sorted, check-passing responses only
    n_sent: int = 0     # requests put on the wire
    n_by_status: Optional[dict] = None   # status -> answered count

    @property
    def n_answered(self) -> int:
        return sum((self.n_by_status or {}).values())

    @property
    def n_dropped(self) -> int:
        """Requests sent but never answered (socket died mid-exchange) —
        the zero-drop acceptance metric for rollbacks under load."""
        return self.n_sent - self.n_answered


def run_load(host: str, port: int, body: str, n_clients: int = 16,
             per_client: int = 125, timeout: float = 30.0,
             check: Optional[Callable] = None,
             post: Optional[Callable] = None) -> LoadResult:
    """Hammer POST / with n_clients keep-alive connections; returns
    sustained req/s over the whole run plus p50/p99 latency. `check`
    (status, payload_bytes) raises to fail a response; default accepts
    any 200. A failed check (or a dead socket, which reconnects) is
    recorded in `errors` and the client KEEPS GOING — callers that want
    the old all-200 contract still assert `not res.errors`.

    `post` routes each request through a callable `(body) -> (status,
    payload_bytes)` instead of a direct connection (a routing tier's
    thread-safe post); host/port are ignored when it is given."""
    lat: list = []
    errors: list = []
    by_status: dict = {}
    sent = [0]
    lock = threading.Lock()

    def default_check(status, payload):
        assert status == 200, (status, payload[:80])

    chk = check or default_check

    def client(cid):
        conn = None
        try:
            for _ in range(per_client):
                if post is None and conn is None:
                    conn = http.client.HTTPConnection(host, port,
                                                      timeout=timeout)
                with lock:
                    sent[0] += 1
                t0 = time.perf_counter()
                try:
                    if post is not None:
                        status, payload = post(body)
                    else:
                        conn.request("POST", "/", body=body)
                        resp = conn.getresponse()
                        payload = resp.read()
                        status = resp.status
                except Exception as e:  # noqa: BLE001 - reported to caller
                    # transport failure: the request is DROPPED (no status
                    # to tally). Reconnect and keep going — one RST must
                    # not silence this client for the rest of the run.
                    with lock:
                        errors.append(e)
                    if conn is not None:
                        try:
                            conn.close()
                        except OSError:
                            pass
                        conn = None
                    continue
                dt = time.perf_counter() - t0
                with lock:
                    by_status[status] = by_status.get(status, 0) + 1
                try:
                    chk(status, payload)
                except Exception as e:  # noqa: BLE001 - recorded, not fatal
                    with lock:
                        errors.append(e)
                    continue
                with lock:
                    lat.append(dt)
        finally:
            if conn is not None:
                conn.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    lat.sort()
    if not lat:
        return LoadResult(0.0, float("inf"), float("inf"), 0, errors, lat,
                          n_sent=sent[0], n_by_status=by_status)
    return LoadResult(
        req_per_sec=len(lat) / wall,
        p50_ms=lat[len(lat) // 2] * 1000,
        p99_ms=lat[int(len(lat) * 0.99)] * 1000,
        n_ok=len(lat), errors=errors, latencies_s=lat,
        n_sent=sent[0], n_by_status=by_status)
