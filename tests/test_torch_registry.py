"""Port parity: the service registry (`mmlspark_tpu_torch.io.registry`).

The twelve behaviours of the reference's `tests/test_serving_registry.py`
run against the port (registration, round robin, failover that evicts a
dead server, HTTP errors returned rather than failed over, keep-alive
pooling, registration retries to a deadline, thread joins on `stop()`,
recovery after every server died, the advertised host). The wire format
is the reference's: the port's `RegistryClient` and `list_services`
against the reference's `ServiceRegistry`, and the other way round, give
equal `list_services` JSON and equal answers. Ports are bound to 0.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from mmlspark_tpu.io import registry as ref_registry
from mmlspark_tpu_torch.io import (RegistryClient, ServiceRegistry,
                                   ServingQuery, ServingServer,
                                   list_services, report_server_to_registry)
from mmlspark_tpu_torch.io import registry as port_registry
from mmlspark_tpu_torch.io.serving import drain_on_signal
from mmlspark_tpu_torch.reliability import RetryPolicy
from mmlspark_tpu_torch.reliability.metrics import reliability_metrics
from mmlspark_tpu_torch.telemetry import names as tnames

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)


def _echo_query(server, tag):
    def transform(bodies):
        return [{"echo": json.loads(b)["x"], "tag": tag} for b in bodies]
    return ServingQuery(server, transform, mode="continuous").start()


@pytest.fixture
def registry():
    reg = ServiceRegistry().start()
    yield reg
    reg.stop()


def test_register_list_unregister(registry):
    report_server_to_registry(registry.address, "svc", "127.0.0.1", 7001,
                              process_id=0)
    report_server_to_registry(registry.address, "svc", "127.0.0.1", 7002,
                              process_id=1)
    report_server_to_registry(registry.address, "other", "127.0.0.1", 7003)
    svcs = list_services(registry.address, "svc")
    assert sorted(s.port for s in svcs) == [7001, 7002]
    assert all(s.address.startswith("http://127.0.0.1:") for s in svcs)
    # unregister removes one endpoint only
    req = urllib.request.Request(
        registry.address + "/unregister",
        data=json.dumps({"name": "svc", "host": "127.0.0.1",
                         "port": 7001}).encode(), method="POST")
    urllib.request.urlopen(req, timeout=10)
    assert [s.port for s in list_services(registry.address, "svc")] == [7002]
    # bad paths/payloads answer with errors, not stack traces
    with urllib.request.urlopen(registry.address + "/services",
                                timeout=10) as r:
        assert r.status == 200
    req = urllib.request.Request(registry.address + "/register",
                                 data=b"{not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400


def test_round_robin_and_failover(registry):
    s1 = ServingServer(num_partitions=1).start()
    s2 = ServingServer(num_partitions=1).start()
    q1 = _echo_query(s1, "a")
    q2 = _echo_query(s2, "b")
    for s in (s1, s2):
        host, port = s._httpd.server_address[:2]
        report_server_to_registry(registry.address, "echo", host, port)
    client = RegistryClient(registry.address, "echo")
    tags = set()
    for i in range(6):
        status, body = client.post(json.dumps({"x": i}).encode())
        assert status == 200
        reply = json.loads(body)
        assert reply["echo"] == i
        tags.add(reply["tag"])
    assert tags == {"a", "b"}  # traffic really round-robins both servers
    # kill server b: the client must fail over and keep answering from a
    q2.stop()
    s2.stop()
    for i in range(4):
        status, body = client.post(json.dumps({"x": 10 + i}).encode())
        assert status == 200
        assert json.loads(body)["tag"] == "a"
    q1.stop()
    s1.stop()


def test_http_error_returned_not_failed_over(registry):
    """A 502 from a healthy server is an ANSWER, not a death: the client
    returns it without re-posting the request elsewhere or marking the
    server dead."""
    s1 = ServingServer(num_partitions=1).start()
    calls = []

    def transform(bodies):
        calls.append(len(bodies))
        raise ValueError("always poison")

    q = ServingQuery(s1, transform, mode="continuous", poll_timeout=0.001)
    q.MAX_REPLAYS = 0  # fail fast to the row-level 502 path
    q.start()
    host, port = s1._httpd.server_address[:2]
    report_server_to_registry(registry.address, "poison", host, port)
    client = RegistryClient(registry.address, "poison")
    try:
        status, body = client.post(json.dumps({"x": 1}).encode())
        assert status == 502
        assert "poison" in json.loads(body)["error"]
        # the server stays in rotation: a second request still reaches it
        status2, _ = client.post(json.dumps({"x": 2}).encode())
        assert status2 == 502
        assert not client._dead
    finally:
        q.stop()
        s1.stop()


def test_failover_evicts_dead_server_from_rotation(registry):
    s1 = ServingServer(num_partitions=1).start()
    s2 = ServingServer(num_partitions=1).start()
    q1 = _echo_query(s1, "a")
    q2 = _echo_query(s2, "b")
    for s in (s1, s2):
        host, port = s._httpd.server_address[:2]
        report_server_to_registry(registry.address, "evict", host, port)
    client = RegistryClient(registry.address, "evict")
    dead_addr = f"http://{s2._httpd.server_address[0]}" \
                f":{s2._httpd.server_address[1]}"
    for i in range(4):
        assert client.post(json.dumps({"x": i}).encode())[0] == 200
    q2.stop()
    s2.stop()
    try:
        tags = []
        for i in range(8):
            status, body = client.post(json.dumps({"x": i}).encode())
            assert status == 200
            tags.append(json.loads(body)["tag"])
        assert set(tags) == {"a"}          # survivors carry all traffic
        assert dead_addr in client._dead   # the corpse left the rotation
    finally:
        q1.stop()
        s1.stop()


def test_client_pools_keepalive_connections(registry):
    s1 = ServingServer(num_partitions=1).start()
    q1 = _echo_query(s1, "ka")
    host, port = s1._httpd.server_address[:2]
    report_server_to_registry(registry.address, "ka", host, port)
    client = RegistryClient(registry.address, "ka")
    try:
        for i in range(6):
            status, _ = client.post(json.dumps({"x": i}).encode())
            assert status == 200
        pool = client._pool()
        assert len(pool) == 1              # one connection, six posts
        conn = next(iter(pool.values()))
        assert conn.sock is not None       # still open (keep-alive held)
        # the socket closes under the client: the next post reconnects
        # to the SAME server, not a failover or an error
        conn.sock.close()
        status, body = client.post(json.dumps({"x": 99}).encode())
        assert status == 200 and json.loads(body)["echo"] == 99
        client.close()
        assert not client._pool()
    finally:
        q1.stop()
        s1.stop()


def test_report_retries_until_registry_up():
    """A worker that starts BEFORE the registry listens keeps retrying
    under its deadline and succeeds once the registry binds."""
    import socket as _socket
    probe = _socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    reg_holder = {}

    def late_start():
        time.sleep(0.3)
        reg_holder["reg"] = ServiceRegistry(port=port).start()

    th = threading.Thread(target=late_start)
    th.start()
    try:
        report_server_to_registry(
            f"http://127.0.0.1:{port}", "late", "127.0.0.1", 7100,
            retry_policy=RetryPolicy(max_attempts=64, backoff=0.05,
                                     jitter=0.2, deadline=10.0))
        th.join()
        svcs = list_services(f"http://127.0.0.1:{port}", "late")
        assert [s.port for s in svcs] == [7100]
    finally:
        th.join()
        if "reg" in reg_holder:
            reg_holder["reg"].stop()


def test_report_gives_up_at_deadline():
    with pytest.raises(RuntimeError, match="after retries"):
        report_server_to_registry(
            "http://127.0.0.1:9", "ghost", "127.0.0.1", 7000,
            retry_policy=RetryPolicy(max_attempts=3, backoff=0.01,
                                     deadline=1.0))


def test_registry_stop_joins_thread():
    reg = ServiceRegistry().start()
    th = reg._thread
    reg.stop()
    assert not th.is_alive()   # no leaked thread between scenarios


def test_no_live_servers_is_clear_error(registry):
    with pytest.raises(RuntimeError, match="ghost"):
        RegistryClient(registry.address, "ghost").post(b"{}")


def test_client_recovers_after_all_dead(registry):
    s1 = ServingServer(num_partitions=1).start()
    q1 = _echo_query(s1, "a")
    host, port = s1._httpd.server_address[:2]
    report_server_to_registry(registry.address, "reborn", host, port)
    client = RegistryClient(registry.address, "reborn")
    status, _ = client.post(json.dumps({"x": 1}).encode())
    assert status == 200
    q1.stop()
    s1.stop()
    with pytest.raises(RuntimeError):
        client.post(json.dumps({"x": 2}).encode())
    # the server comes back on a NEW port and re-registers
    s2 = ServingServer(num_partitions=1).start()
    q2 = _echo_query(s2, "b")
    host2, port2 = s2._httpd.server_address[:2]
    report_server_to_registry(registry.address, "reborn", host2, port2)
    try:
        status, body = client.post(json.dumps({"x": 3}).encode())
        assert status == 200 and json.loads(body)["tag"] == "b"
    finally:
        q2.stop()
        s2.stop()


def test_unregister_rejects_non_object_body(registry):
    req = urllib.request.Request(registry.address + "/unregister",
                                 data=b"[1,2]", method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400


def test_advertised_host_resolution():
    adv = port_registry._advertised_host
    assert adv("10.0.0.7", None) == "10.0.0.7"
    assert adv("0.0.0.0", None) not in ("0.0.0.0", "::", "")
    assert adv("0.0.0.0", "gpu-host-3") == "gpu-host-3"
    for args in (("10.0.0.7", None), ("0.0.0.0", "gpu-host-3"),
                 ("0.0.0.0", None)):
        assert adv(*args) == ref_registry._advertised_host(*args)


# ------------------------------------------------ the port's own contracts
def test_ttl_evicts_stale_entries():
    now = [100.0]
    reg = ServiceRegistry(ttl_s=5.0, clock=lambda: now[0]).start()
    reliability_metrics.reset()
    try:
        report_server_to_registry(reg.address, "ttl", "127.0.0.1", 7201)
        report_server_to_registry(reg.address, "ttl", "127.0.0.1", 7202)
        now[0] += 4.0
        # re-registration is the heartbeat: 7202 stays fresh
        report_server_to_registry(reg.address, "ttl", "127.0.0.1", 7202)
        now[0] += 2.0
        assert [s.port for s in list_services(reg.address, "ttl")] == [7202]
        assert reliability_metrics.get(tnames.REGISTRY_EVICTIONS) == 1
    finally:
        reg.stop()
        reliability_metrics.reset()


def test_kind_and_version_ride_the_wire(registry):
    """A serving worker without a version posts the reference's pre-kind,
    pre-version body; a trainer says its kind, a versioned worker its
    version, and both parse back."""
    report_server_to_registry(registry.address, "fleet", "127.0.0.1", 7301)
    report_server_to_registry(registry.address, "fleet", "127.0.0.1", 7302,
                              kind="trainer", version="abc123")
    with urllib.request.urlopen(registry.address + "/services/fleet",
                                timeout=10) as r:
        raw = sorted(json.loads(r.read()), key=lambda d: d["port"])
    assert raw[0]["kind"] == "serving" and raw[0]["version"] is None
    assert raw[1]["kind"] == "trainer" and raw[1]["version"] == "abc123"


@pytest.mark.parametrize("registry_side", ["reference", "port"])
def test_wire_format_interoperates(registry_side):
    """The port's client against the reference's registry, and the
    reference's client against the port's: the same registrations give
    equal `list_services` JSON from both packages' readers, and both
    clients round-robin the same servers."""
    reg_cls = (ref_registry.ServiceRegistry if registry_side == "reference"
               else port_registry.ServiceRegistry)
    reg = reg_cls().start()
    s1 = ServingServer(num_partitions=1).start()
    s2 = ServingServer(num_partitions=1).start()
    q1 = _echo_query(s1, "a")
    q2 = _echo_query(s2, "b")
    try:
        (h1, p1), (h2, p2) = (s._httpd.server_address[:2] for s in (s1, s2))
        # one registration from each package's reporter
        port_registry.report_server_to_registry(
            reg.address, "mix", h1, p1, process_id=0, version="v-port")
        ref_registry.report_server_to_registry(
            reg.address, "mix", h2, p2, process_id=1, num_partitions=1)
        ports = port_registry.list_services(reg.address, "mix")
        refs = ref_registry.list_services(reg.address, "mix")
        assert sorted((i._asdict() for i in ports), key=str) == \
            sorted((i._asdict() for i in refs), key=str)
        assert {i.version for i in ports} == {"v-port", None}
        for client_cls in (port_registry.RegistryClient,
                           ref_registry.RegistryClient):
            client = client_cls(reg.address, "mix")
            tags = set()
            for i in range(4):
                status, body = client.post(json.dumps({"x": i}).encode())
                assert status == 200 and json.loads(body)["echo"] == i
                tags.add(json.loads(body)["tag"])
            assert tags == {"a", "b"}
            client.close()
    finally:
        for q in (q1, q2):
            q.stop()
        for s in (s1, s2):
            s.stop()
        reg.stop()


def test_drain_on_signal_stops_registries_last():
    """`drain_on_signal(registries=)`: servers drain, then queries, then
    the leader's registry goes down (its thread joined)."""
    reg = ServiceRegistry().start()
    s1 = ServingServer(num_partitions=1).start()
    q1 = _echo_query(s1, "a")
    order = []
    s_stop, q_stop, r_stop = s1.stop, q1.stop, reg.stop
    s1.stop = lambda **kw: (order.append("server"), s_stop(**kw))
    q1.stop = lambda: (order.append("query"), q_stop())
    reg.stop = lambda: (order.append("registry"), r_stop())
    import signal
    prev = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    try:
        handler = drain_on_signal(servers=[s1], queries=[q1],
                                  registries=[reg], exit_code=None)
        handler()
        assert order == ["server", "query", "registry"]
        assert not reg._thread.is_alive()
    finally:
        signal.signal(signal.SIGTERM, prev[0])
        signal.signal(signal.SIGINT, prev[1])


def test_stopped_server_leaves_the_registry():
    """A server that `start_distributed_serving` registered takes its own
    entry out when it stops (as `drain_on_signal` stops it on SIGTERM);
    a stop after the registry is gone still completes."""
    from mmlspark_tpu_torch.io import start_distributed_serving

    def transform(bodies):
        return [{"ok": 1} for _ in bodies]

    reg, server, query, addr = start_distributed_serving(
        transform, name="leave", mode="continuous")
    try:
        assert [s.port for s in list_services(addr, "leave")] == \
            [server._httpd.server_address[1]]
        server.stop()
        assert list_services(addr, "leave") == []
        assert not server._thread.is_alive()
    finally:
        query.stop()
        reg.stop()
    other = ServingServer(num_partitions=1).start()
    other._leave_registry = lambda: port_registry._unregister(
        addr, "leave", "127.0.0.1", 1, timeout=2.0)
    other.stop()
    assert not other._thread.is_alive()
