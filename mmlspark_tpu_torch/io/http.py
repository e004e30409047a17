"""HTTP-on-Table: a column of requests -> a column of responses.

A copy of the reference's `io/http.py`, which imports no JAX (role: the
reference's HTTP-on-Spark stack, io/http/, 1,479 LoC), on the port's
Table, `reliability/policy.py::RetryPolicy` and
`utils/async_utils.bounded_map`:
- `HTTPRequest`/`HTTPResponse` dataclasses play HTTPSchema's request/response
  rows (io/http/HTTPSchema.scala);
- `HTTPTransformer` is the async per-partition client with bounded
  concurrency (io/http/HTTPTransformer.scala:82-141, via
  utils.async_utils.bounded_map = AsyncUtils.bufferedAwait);
- handler strategies mirror HandlingUtils.basic/advanced — `advanced` retries
  with exponential backoff and honors 429 Retry-After
  (io/http/HTTPClients.scala:65-156);
- parsers mirror Parsers.scala:26-250 (JSONInputParser, CustomInputParser,
  JSONOutputParser, StringOutputParser, CustomOutputParser);
- `SimpleHTTPTransformer` composes parser -> client -> parser
  (io/http/SimpleHTTPTransformer.scala);
- `PartitionConsolidator` funnels all partitions through one rate-limited
  worker (io/http/PartitionConsolidator.scala:18-136).

Everything is stdlib urllib.
"""
from __future__ import annotations

import dataclasses
import json
import urllib.error
import urllib.request
from typing import Callable, Optional

import numpy as np

from ..core import Param, Table, Transformer, HasInputCol, HasOutputCol
from ..core.params import in_range, one_of
from ..reliability.policy import RetryPolicy
from ..utils.async_utils import bounded_map
from ..telemetry.names import HTTP_RETRIES


@dataclasses.dataclass
class HTTPRequest:
    """reference: HTTPRequestData (io/http/HTTPSchema.scala)."""
    url: str
    method: str = "GET"
    headers: Optional[dict] = None
    body: Optional[bytes] = None

    def _to_json(self):
        body = self.body.decode("latin-1") if self.body is not None else None
        return {"url": self.url, "method": self.method,
                "headers": self.headers, "body": body}

    @classmethod
    def _from_json(cls, d):
        body = d.get("body")
        return cls(url=d["url"], method=d.get("method", "GET"),
                   headers=d.get("headers"),
                   body=body.encode("latin-1") if body is not None else None)


@dataclasses.dataclass
class HTTPResponse:
    """reference: HTTPResponseData (io/http/HTTPSchema.scala)."""
    status: int
    reason: str = ""
    headers: Optional[dict] = None
    body: bytes = b""
    error: Optional[str] = None

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", errors="replace")

    def json(self):
        return json.loads(self.text)


def _send_once(req: HTTPRequest, timeout: float) -> HTTPResponse:
    r = urllib.request.Request(req.url, data=req.body, method=req.method,
                               headers=req.headers or {})
    try:
        with urllib.request.urlopen(r, timeout=timeout) as resp:
            return HTTPResponse(status=resp.status, reason=resp.reason or "",
                                headers=dict(resp.headers), body=resp.read())
    except urllib.error.HTTPError as e:
        return HTTPResponse(status=e.code, reason=str(e.reason),
                            headers=dict(e.headers) if e.headers else {},
                            body=e.read() if hasattr(e, "read") else b"")


def basic_handler(req: HTTPRequest, timeout: float = 60.0) -> HTTPResponse:
    """reference: HandlingUtils.basic — single attempt, errors surfaced."""
    return _send_once(req, timeout)


_CONNECTION_ERRORS = (urllib.error.URLError, ConnectionError, TimeoutError,
                      OSError)


def advanced_handler(req: HTTPRequest, timeout: float = 60.0,
                     retry_times: int = 3, backoff: float = 0.1,
                     policy: Optional[RetryPolicy] = None) -> HTTPResponse:
    """reference: HandlingUtils.advanced (HTTPClients.scala:65-156): retry
    connection failures and 429s with jittered exponential backoff; 429
    honors a Retry-After header when present. The loop shape (backoff,
    jitter, overall deadline, budget) comes from `policy` — the same
    RetryPolicy the rest of the framework retries with; `retry_times` /
    `backoff` build a default one."""
    if policy is None:
        policy = RetryPolicy(max_attempts=retry_times, backoff=backoff,
                             metric_name=HTTP_RETRIES)
    last_err = None
    resp: Optional[HTTPResponse] = None
    for attempt in policy.attempts():
        try:
            resp = _send_once(req, attempt.timeout(timeout))
        except _CONNECTION_ERRORS as e:
            last_err, resp = e, None
            attempt.retry()
            continue
        if resp.status == 429 and not attempt.is_last:
            retry_after = (resp.headers or {}).get("Retry-After")
            try:
                wait = float(retry_after) if retry_after else None
            except ValueError:
                wait = None
            attempt.retry(delay=wait)
            continue
        if policy.budget is not None:
            policy.budget.on_success()
        return resp
    if resp is not None:
        return resp  # retries exhausted on a throttled (429) response
    if last_err is not None:
        return HTTPResponse(status=0, reason="connection failed",
                            error=f"{type(last_err).__name__}: {last_err}")
    return HTTPResponse(status=0, reason="retries exhausted")


class HTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """Column of HTTPRequest -> column of HTTPResponse with bounded-
    concurrency pipelining (reference: HTTPTransformer.scala:82-141)."""
    concurrency = Param("concurrency", "max in-flight requests per partition", 1,
                        validator=in_range(1))
    concurrent_timeout = Param("concurrent_timeout",
                               "seconds to wait on any single future", None)
    timeout = Param("timeout", "per-request socket timeout (s)", 60.0)
    handler = Param("handler", "basic|advanced", "advanced",
                    validator=one_of("basic", "advanced"))
    custom_handler = Param("custom_handler",
                           "callable (HTTPRequest) -> HTTPResponse; overrides "
                           "`handler`", None, transient=True)
    retry_times = Param("retry_times", "advanced handler retries", 3)
    backoff = Param("backoff", "advanced handler initial backoff (s)", 0.1)
    deadline = Param("deadline", "overall per-request retry budget (s); "
                     "attempts+sleeps never exceed it", None)
    retry_policy = Param("retry_policy",
                         "reliability.RetryPolicy overriding retry_times/"
                         "backoff/deadline (shared budgets, custom jitter)",
                         None, transient=True)
    retry_metric_name = Param("retry_metric_name",
                              "reliability counter retries land under",
                              HTTP_RETRIES)

    def _build_policy(self) -> RetryPolicy:
        if self.retry_policy is not None:
            return self.retry_policy
        return RetryPolicy(max_attempts=self.retry_times, backoff=self.backoff,
                           deadline=self.deadline,
                           metric_name=self.retry_metric_name)

    def _handler_fn(self) -> Callable[[HTTPRequest], HTTPResponse]:
        if self.custom_handler is not None:
            return self.custom_handler
        if self.handler == "basic":
            return lambda r: basic_handler(r, self.timeout)
        policy = self._build_policy()
        return lambda r: advanced_handler(r, self.timeout, policy=policy)

    def _transform(self, t: Table) -> Table:
        fn = self._handler_fn()
        reqs = t[self.input_col]
        out = list(bounded_map(fn, list(reqs), self.concurrency,
                               timeout=self.concurrent_timeout))
        col = np.empty(len(out), dtype=object)
        col[:] = out
        return t.with_column(self.output_col, col)


# ---------------------------------------------------------------- parsers
class JSONInputParser(Transformer, HasInputCol, HasOutputCol):
    """JSON-encode a column into POST requests (Parsers.scala: JSONInputParser)."""
    url = Param("url", "target URL", None)
    method = Param("method", "HTTP method", "POST")
    headers = Param("headers", "extra headers", None)

    def _transform(self, t: Table) -> Table:
        headers = {"Content-Type": "application/json", **(self.headers or {})}
        vals = t[self.input_col]
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            payload = v if isinstance(v, (dict, list, str, int, float, bool)) \
                else np.asarray(v).tolist()
            out[i] = HTTPRequest(url=self.url, method=self.method,
                                 headers=dict(headers),
                                 body=json.dumps(payload).encode())
        return t.with_column(self.output_col, out)


class CustomInputParser(Transformer, HasInputCol, HasOutputCol):
    """udf row -> HTTPRequest (Parsers.scala: CustomInputParser)."""
    udf = Param("udf", "callable value -> HTTPRequest", None, transient=True)

    def _transform(self, t: Table) -> Table:
        vals = t[self.input_col]
        out = np.empty(len(vals), dtype=object)
        for i, v in enumerate(vals):
            out[i] = self.udf(v)
        return t.with_column(self.output_col, out)


class JSONOutputParser(Transformer, HasInputCol, HasOutputCol):
    """HTTPResponse -> parsed JSON object column (Parsers.scala: JSONOutputParser)."""

    def _transform(self, t: Table) -> Table:
        vals = t[self.input_col]
        out = np.empty(len(vals), dtype=object)
        for i, r in enumerate(vals):
            try:
                out[i] = r.json() if r is not None and r.status else None
            except (ValueError, AttributeError):
                out[i] = None
        return t.with_column(self.output_col, out)


class StringOutputParser(Transformer, HasInputCol, HasOutputCol):
    """HTTPResponse -> body text column (Parsers.scala: StringOutputParser)."""

    def _transform(self, t: Table) -> Table:
        vals = t[self.input_col]
        out = np.asarray([r.text if r is not None else "" for r in vals],
                         dtype=object)
        return t.with_column(self.output_col, out)


class CustomOutputParser(Transformer, HasInputCol, HasOutputCol):
    """udf HTTPResponse -> value (Parsers.scala: CustomOutputParser)."""
    udf = Param("udf", "callable HTTPResponse -> value", None, transient=True)

    def _transform(self, t: Table) -> Table:
        vals = t[self.input_col]
        out = np.empty(len(vals), dtype=object)
        for i, r in enumerate(vals):
            out[i] = self.udf(r)
        return t.with_column(self.output_col, out)


class SimpleHTTPTransformer(Transformer, HasInputCol, HasOutputCol):
    """input parser -> HTTPTransformer -> output parser, one stage
    (reference: SimpleHTTPTransformer.scala)."""
    url = Param("url", "target URL", None)
    input_parser = Param("input_parser", "Transformer producing requests", None)
    output_parser = Param("output_parser", "Transformer consuming responses", None)
    concurrency = Param("concurrency", "max in-flight requests", 1)
    handler = Param("handler", "basic|advanced", "advanced")
    timeout = Param("timeout", "per-request timeout (s)", 60.0)
    retry_times = Param("retry_times", "advanced handler retries", 3)
    backoff = Param("backoff", "advanced handler initial backoff (s)", 0.1)

    def _transform(self, t: Table) -> Table:
        req_col = t.find_unused_column_name("__http_request")
        resp_col = t.find_unused_column_name("__http_response")
        in_parser = self.input_parser or JSONInputParser(url=self.url)
        in_parser = in_parser.copy({"input_col": self.input_col,
                                    "output_col": req_col})
        client = HTTPTransformer(
            input_col=req_col, output_col=resp_col,
            concurrency=self.concurrency, handler=self.handler,
            timeout=self.timeout, retry_times=self.retry_times,
            backoff=self.backoff)
        out_parser = self.output_parser or JSONOutputParser()
        out_parser = out_parser.copy({"input_col": resp_col,
                                      "output_col": self.output_col})
        out = out_parser.transform(client.transform(in_parser.transform(t)))
        return out.drop(req_col, resp_col)


class PartitionConsolidator(Transformer, HasInputCol, HasOutputCol):
    """Funnel all partitions' rows through ONE worker (rate-limited services
    get a single connection per host — reference:
    PartitionConsolidator.scala:18-136). In the Table runtime this pins the
    transform to one logical partition and restores the original partition
    count afterwards."""
    inner = Param("inner", "Transformer to run consolidated", None)

    def _transform(self, t: Table) -> Table:
        original = t.npartitions
        consolidated = t.repartition(1)
        out = (self.inner.transform(consolidated) if self.inner is not None
               else consolidated)
        return out.repartition(original)
