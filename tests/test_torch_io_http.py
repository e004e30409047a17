"""Port parity: `io/http.py`, `io/powerbi.py`, `io/shared.py` and
`reliability/policy.py`'s circuit breaker.

Against a local echo server on port 0 (every request with an explicit
timeout, so nothing can hang under xdist), both packages in one process:
- the client transformers' answers equal the reference's; dropped
  connections and 429s retry, the 429's `Retry-After` becomes the sleep,
  and with an injected sleep and a seeded jitter the sleeps equal the
  reference's one for one; each retry counts under `http.retries`;
- the input/output parsers and `PartitionConsolidator` equal;
- `powerbi.write` sends every row once in its batches, and fails loudly
  on a non-200;
- `shared_singleton` builds once per name across threads;
  `forward_port_to_remote` walks remote ports past a fake `ssh` on PATH
  that refuses the first ones, and surfaces its real errors;
- `CircuitBreaker` opens, half-opens and closes as the reference's on the
  same outcomes under a fake clock.
None of these tests times throughput.
"""
import json
import os
import random
import stat
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from mmlspark_tpu import Table as RefTable
from mmlspark_tpu.io import http as ref_http
from mmlspark_tpu.io import powerbi as ref_powerbi
from mmlspark_tpu.reliability import policy as ref_policy
from mmlspark_tpu.reliability.policy import RetryPolicy as RefRetryPolicy
from mmlspark_tpu_torch import Table
from mmlspark_tpu_torch.io import (CustomInputParser, CustomOutputParser,
                                   HTTPRequest, HTTPResponse,
                                   HTTPTransformer, JSONInputParser,
                                   JSONOutputParser, PartitionConsolidator,
                                   SharedVariable, SimpleHTTPTransformer,
                                   StringOutputParser,
                                   forward_port_to_remote, shared_singleton)
from mmlspark_tpu_torch.io import http, powerbi
from mmlspark_tpu_torch.reliability import (CircuitBreaker,
                                            CircuitOpenError, RetryPolicy)
from mmlspark_tpu_torch.reliability.metrics import (MetricsRegistry,
                                                    reliability_metrics)
from mmlspark_tpu_torch.telemetry import names as tnames

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_TIMEOUT = 10.0


class _Echo(BaseHTTPRequestHandler):
    """POST echoes the JSON body; can drop connections, answer 429 with
    Retry-After, or 500, a given number of times."""
    drop = 0
    throttle = 0
    fail = 0
    lock = threading.Lock()
    bodies: list = []

    def do_POST(self):  # noqa: N802 (stdlib naming)
        cls = type(self)
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        with cls.lock:
            if cls.drop > 0:
                cls.drop -= 1
                self.connection.close()
                return
            if cls.throttle > 0:
                cls.throttle -= 1
                self.send_response(429)
                self.send_header("Retry-After", "0.25")
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            status = 200
            if cls.fail > 0:
                cls.fail -= 1
                status = 500
            cls.bodies.append(body)
        try:
            val = json.loads(body)
        except ValueError:
            val = None
        out = json.dumps({"echo": val}).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(out)))
        self.end_headers()
        self.wfile.write(out)

    def log_message(self, *a):
        pass


@pytest.fixture
def echo():
    _Echo.drop = _Echo.throttle = _Echo.fail = 0
    _Echo.bodies = []
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}/"
    httpd.shutdown()
    httpd.server_close()
    th.join(timeout=_TIMEOUT)


def _requests(module, url, vals):
    col = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):
        col[i] = module.HTTPRequest(
            url=url, method="POST",
            headers={"Content-Type": "application/json"},
            body=json.dumps(v).encode())
    return col


def test_transformer_answers_equal_reference(echo):
    vals = [1, "two", [3, 4], {"five": 5.5}, None, 6]
    got = HTTPTransformer(input_col="req", output_col="resp", concurrency=4,
                          timeout=_TIMEOUT).transform(
        Table({"req": _requests(http, echo, vals)}))["resp"]
    want = ref_http.HTTPTransformer(
        input_col="req", output_col="resp", concurrency=4,
        timeout=_TIMEOUT).transform(
        RefTable({"req": _requests(ref_http, echo, vals)}))["resp"]
    assert [r.status for r in got] == [r.status for r in want] == [200] * 6
    assert [r.json() for r in got] == [r.json() for r in want] == [
        {"echo": v} for v in vals]


def _sleeps_of(module_http, policy_cls, echo, drop, throttle, reg=None):
    sleeps = []
    _Echo.drop, _Echo.throttle = drop, throttle
    policy = policy_cls(max_attempts=5, backoff=0.5, jitter=0.1,
                        rng=random.Random(3), sleep=sleeps.append,
                        metrics=reg, metric_name=tnames.HTTP_RETRIES)
    table_cls = Table if module_http is http else RefTable
    out = module_http.HTTPTransformer(
        input_col="req", output_col="resp", retry_policy=policy,
        timeout=_TIMEOUT).transform(
        table_cls({"req": _requests(module_http, echo, [42])}))
    return out["resp"][0], sleeps


@pytest.mark.parametrize("drop, throttle", [(2, 0), (0, 2), (1, 1)])
def test_retries_and_429_sleeps_equal_reference(echo, drop, throttle):
    reg = MetricsRegistry()
    resp, sleeps = _sleeps_of(http, RetryPolicy, echo, drop, throttle, reg)
    ref_resp, ref_sleeps = _sleeps_of(ref_http, RefRetryPolicy, echo, drop,
                                      throttle)
    assert resp.status == ref_resp.status == 200
    assert resp.json() == {"echo": 42}
    assert sleeps == ref_sleeps and len(sleeps) == drop + throttle
    # a 429 sleeps its Retry-After, a dropped connection the backoff
    assert sleeps.count(0.25) == throttle
    assert reg.get(tnames.HTTP_RETRIES) == drop + throttle


def test_transformer_retries_count_under_http_retries(echo):
    reliability_metrics.reset(tnames.HTTP_RETRIES)
    _Echo.drop = 1
    out = HTTPTransformer(input_col="req", output_col="resp", retry_times=3,
                          backoff=0.001, timeout=_TIMEOUT).transform(
        Table({"req": _requests(http, echo, [5])}))
    assert out["resp"][0].json() == {"echo": 5}
    assert reliability_metrics.get(tnames.HTTP_RETRIES) == 1


def test_429_exhausted_returns_the_throttle(echo):
    _Echo.throttle = 5
    sleeps = []
    resp = http.advanced_handler(
        HTTPRequest(url=echo, method="POST", body=b"1"), timeout=_TIMEOUT,
        policy=RetryPolicy(max_attempts=2, sleep=sleeps.append,
                           metrics=MetricsRegistry()))
    assert resp.status == 429 and sleeps == [0.25]


def test_basic_handler_does_not_retry(echo):
    _Echo.throttle = 1
    resp = http.basic_handler(HTTPRequest(url=echo, method="POST",
                                          body=b"1"), timeout=_TIMEOUT)
    assert resp.status == 429


def test_connection_refused_is_a_response():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    url = f"http://127.0.0.1:{httpd.server_address[1]}/"
    httpd.server_close()
    resp = http.advanced_handler(
        HTTPRequest(url=url, method="POST", body=b"1"), timeout=_TIMEOUT,
        policy=RetryPolicy(max_attempts=2, sleep=lambda s: None,
                           metrics=MetricsRegistry()))
    assert resp.status == 0 and "connection failed" in resp.reason
    assert resp.error


def test_simple_transformer_and_parsers_equal_reference(echo):
    x = np.asarray([1.5, 2.5, -3.0])
    got = SimpleHTTPTransformer(input_col="x", output_col="y", url=echo,
                                concurrency=2, timeout=_TIMEOUT).transform(
        Table({"x": x}))
    want = ref_http.SimpleHTTPTransformer(
        input_col="x", output_col="y", url=echo, concurrency=2,
        timeout=_TIMEOUT).transform(RefTable({"x": x}))
    assert list(got["y"]) == list(want["y"]) == [{"echo": v} for v in x]
    assert set(got.columns) == {"x", "y"}

    reqs = JSONInputParser(input_col="x", output_col="r", url=echo,
                           headers={"X-A": "1"}).transform(Table({"x": x}))
    ref_reqs = ref_http.JSONInputParser(
        input_col="x", output_col="r", url=echo,
        headers={"X-A": "1"}).transform(RefTable({"x": x}))
    assert [r._to_json() for r in reqs["r"]] == [
        r._to_json() for r in ref_reqs["r"]]
    custom = CustomInputParser(
        input_col="x", output_col="r",
        udf=lambda v: HTTPRequest(url=echo, body=str(v).encode())
    ).transform(Table({"x": x}))
    assert [r.body for r in custom["r"]] == [b"1.5", b"2.5", b"-3.0"]
    resps = np.asarray([HTTPResponse(status=200, body=b'{"a": 1}'),
                        HTTPResponse(status=0, body=b""),
                        HTTPResponse(status=200, body=b"not json")],
                       dtype=object)
    for port_cls, ref_cls in ((JSONOutputParser, ref_http.JSONOutputParser),
                              (StringOutputParser,
                               ref_http.StringOutputParser)):
        a = port_cls(input_col="r", output_col="o").transform(
            Table({"r": resps}))["o"]
        b = ref_cls(input_col="r", output_col="o").transform(
            RefTable({"r": resps}))["o"]
        assert list(a) == list(b)
    out = CustomOutputParser(input_col="r", output_col="o",
                             udf=lambda r: r.status * 2).transform(
        Table({"r": resps}))["o"]
    assert list(out) == [400, 0, 400]


def test_partition_consolidator(echo):
    t = Table({"x": np.arange(8).astype(np.float32)}, npartitions=4)
    inner = SimpleHTTPTransformer(input_col="x", output_col="y", url=echo,
                                  timeout=_TIMEOUT)
    out = PartitionConsolidator(inner=inner).transform(t)
    assert out.npartitions == 4
    assert [v["echo"] for v in out["y"]] == list(range(8))
    ref_out = ref_http.PartitionConsolidator(
        inner=ref_http.SimpleHTTPTransformer(
            input_col="x", output_col="y", url=echo, timeout=_TIMEOUT)
    ).transform(RefTable({"x": np.arange(8).astype(np.float32)},
                         npartitions=4))
    assert list(out["y"]) == list(ref_out["y"])


def test_request_json_round_trip():
    req = HTTPRequest(url="http://h/", method="PUT", headers={"a": "b"},
                      body=bytes(range(256)))
    back = HTTPRequest._from_json(json.loads(json.dumps(req._to_json())))
    assert back == req
    assert req._to_json() == ref_http.HTTPRequest(
        url="http://h/", method="PUT", headers={"a": "b"},
        body=bytes(range(256)))._to_json()


# ------------------------------------------------------------------ Power BI
def _rows(n):
    return {"id": np.arange(n), "score": np.linspace(-1.0, 1.0, n),
            "name": np.asarray([f"n{i}" for i in range(n)], dtype=object)}


@pytest.mark.parametrize("batch_size, concurrency", [(10, 1), (7, 3)])
def test_powerbi_batches_every_row_once(echo, batch_size, concurrency):
    n = 45
    sent = powerbi.write(Table(_rows(n)), echo, batch_size=batch_size,
                         concurrency=concurrency, timeout=_TIMEOUT)
    assert sent == -(-n // batch_size) == len(_Echo.bodies)
    rows = [r for b in _Echo.bodies for r in json.loads(b)]
    assert sorted(r["id"] for r in rows) == list(range(n))
    port_bodies = sorted(_Echo.bodies)
    _Echo.bodies = []
    ref_powerbi.write(RefTable(_rows(n)), echo, batch_size=batch_size,
                      concurrency=concurrency, timeout=_TIMEOUT)
    assert sorted(_Echo.bodies) == port_bodies


def test_powerbi_fails_loud(echo):
    _Echo.fail = 1
    with pytest.raises(powerbi.PowerBIWriteError, match="500"):
        powerbi.write(Table(_rows(5)), echo, batch_size=10,
                      timeout=_TIMEOUT)


# ------------------------------------------------------- shared variables
def test_shared_singleton_once_per_name():
    calls = []

    def make():
        calls.append(1)
        return object()

    a = SharedVariable(make, name="t_torch_shared_x")
    outs = []
    ts = [threading.Thread(target=lambda: outs.append(a.get))
          for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=_TIMEOUT)
    assert len(calls) == 1 and all(o is outs[0] for o in outs)
    assert shared_singleton("t_torch_shared_x", make) is outs[0]
    assert len(calls) == 1
    assert SharedVariable(make).get is not outs[0] and len(calls) == 2


_FAKE_SSH = """#!{python}
import sys, time
args = sys.argv[1:]
spec = args[args.index("-R") + 1]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
port = int(spec.split(":")[1])
if {auth_fail}:
    sys.stderr.write("Permission denied (publickey).\\n")
    sys.exit(255)
if port < {first_free}:
    sys.stderr.write("Error: remote port forwarding failed for listen "
                     "port %d\\n" % port)
    sys.exit(255)
time.sleep(30)
"""


def _fake_ssh(tmp_path, monkeypatch, first_free=9003, auth_fail=False):
    log = str(tmp_path / "ssh.log")
    path = tmp_path / "ssh"
    path.write_text(_FAKE_SSH.format(python=sys.executable, log=log,
                                     first_free=first_free,
                                     auth_fail=auth_fail))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}"
                       f"{os.environ.get('PATH', '')}")
    return log


def test_forward_port_walks_remote_ports(tmp_path, monkeypatch):
    log = _fake_ssh(tmp_path, monkeypatch)
    fwd = forward_port_to_remote("u", "gateway", 8888, 9000, ssh_port=2222,
                                 key_file="/k", settle_timeout=1.0)
    try:
        assert fwd.remote_port == 9003 and fwd.local_port == 8888
        assert fwd.process.poll() is None
        with open(log) as f:
            calls = f.read().splitlines()
        assert [c.split("-R ")[1].split()[0] for c in calls] == [
            f"*:{p}:127.0.0.1:8888" for p in range(9000, 9004)]
        assert calls[0].startswith("-i /k -N -o ExitOnForwardFailure=yes")
        assert calls[0].endswith("-p 2222 -R *:9000:127.0.0.1:8888 "
                                 "u@gateway")
    finally:
        fwd.stop()
    assert fwd.process.poll() is not None


def test_forward_port_surfaces_real_ssh_errors(tmp_path, monkeypatch):
    log = _fake_ssh(tmp_path, monkeypatch, auth_fail=True)
    with pytest.raises(RuntimeError, match="Permission denied"):
        forward_port_to_remote("u", "gw", 8888, 9000, settle_timeout=1.0)
    with open(log) as f:
        assert len(f.read().splitlines()) == 1   # no walk over ports


def test_forward_port_gives_up_after_max_attempts():
    attempts = []

    def busy(*a, **kw):
        attempts.append(a[4])
        return None
    with pytest.raises(RuntimeError, match="after 3 attempts"):
        forward_port_to_remote("u", "gw", 1, 500, max_attempts=3,
                               _runner=busy)
    assert attempts == [500, 501, 502]


# ------------------------------------------------------- circuit breaker
def _drive(breaker_cls, open_err, outcomes, clock):
    """Run a script of (advance s, outcome) through a breaker; record the
    state after each step and whether the call was admitted."""
    reg = MetricsRegistry()
    br = breaker_cls(failure_threshold=3, failure_rate=0.5, window=6,
                     reset_timeout=10.0, clock=lambda: clock[0],
                     metrics=reg, name="svc")
    trace = []
    for advance, ok in outcomes:
        clock[0] += advance

        def fn():
            if not ok:
                raise ValueError("down")
            return "up"
        try:
            got = br.call(fn)
        except open_err:
            got = "open"
        except ValueError:
            got = "failed"
        trace.append((got, br.state))
    return trace, reg.get("svc.trips")


def test_circuit_breaker_equals_reference():
    script = ([(0, True)] * 2 + [(0, False)] * 3 + [(1, True)] * 2
              + [(10, False)] + [(1, True)] + [(10, True)] + [(0, True)]
              + [(0, False)] * 4 + [(10, True)])
    got, trips = _drive(CircuitBreaker, CircuitOpenError, script, [0.0])
    want, ref_trips = _drive(ref_policy.CircuitBreaker,
                             ref_policy.CircuitOpenError, script, [0.0])
    assert got == want
    assert trips == ref_trips >= 2
    states = [s for _, s in got]
    assert {"closed", "open", "half_open"} >= set(states)
    assert ("open", "open") in got and got[-1] == ("up", "closed")
    assert tnames.breaker_trips("svc") == "svc.trips"
