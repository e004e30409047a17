"""Retry with jittered backoff, an overall deadline and a shared budget;
the circuit breaker.

A copy of the reference's `reliability/policy.py`, which imports no JAX:
`RetryPolicy` and what it needs (`Deadline`, `RetryBudget`, `Attempt`),
and `CircuitBreaker` with `CircuitOpenError`. `TrainingSupervisor`
bounds its in-run step restarts with the policy, and `io/http.py`'s
advanced handler retries with it.

- `RetryPolicy.attempts()` is the loop: yields `Attempt`s, sleeps jittered
  exponential backoff between them, stops on attempt count, overall
  `deadline`, or an exhausted shared `RetryBudget`.
- `Deadline` propagates one time budget through nested timeouts
  (`deadline.clamp(per_attempt_timeout)`).
- `CircuitBreaker` is the closed/open/half-open failure-rate breaker that
  stops hammering a dead dependency (trips recorded in
  `reliability.metrics`).

Everything takes an injectable `sleep`/`clock` so tests run in
microseconds, and an injectable `rng` so jittered schedules are
reproducible.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, TypeVar

from . import names as tnames
from .metrics import reliability_metrics

T = TypeVar("T")

_INF = float("inf")


class Deadline:
    """Absolute time budget on the monotonic clock; `never()` is infinite."""

    __slots__ = ("_at", "_clock")

    def __init__(self, at: float, clock: Callable[[], float] = time.monotonic):
        self._at = at
        self._clock = clock

    @classmethod
    def after(cls, seconds: Optional[float],
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        if seconds is None:
            return cls(_INF, clock)
        return cls(clock() + seconds, clock)

    @classmethod
    def never(cls) -> "Deadline":
        return cls(_INF)

    def remaining(self) -> float:
        return max(self._at - self._clock(), 0.0) if self._at != _INF else _INF

    def expired(self) -> bool:
        return self._at != _INF and self._clock() >= self._at

    def clamp(self, timeout: Optional[float]) -> Optional[float]:
        """Per-attempt timeout that cannot outlive the overall budget.
        None stays None on an infinite deadline (block freely)."""
        rem = self.remaining()
        if rem == _INF:
            return timeout
        return rem if timeout is None else min(timeout, rem)

    def __repr__(self):
        rem = self.remaining()
        return f"Deadline(remaining={'inf' if rem == _INF else f'{rem:.3f}s'})"


class RetryBudget:
    """Token bucket bounding the RATIO of retries to work: each retry
    spends a token, each success refunds `success_credit`. Shared across
    calls (and threads), it caps the retry multiplier under an outage."""

    def __init__(self, tokens: float = 10.0, success_credit: float = 0.1,
                 max_tokens: Optional[float] = None):
        self._max = max_tokens if max_tokens is not None else tokens
        self._tokens = min(tokens, self._max)
        self._credit = success_credit
        self._lock = threading.Lock()

    def can_retry(self) -> bool:
        with self._lock:
            return self._tokens >= 1.0

    def on_retry(self) -> bool:
        """Spend one token; False (no retry) when the bucket is empty."""
        with self._lock:
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
            return True

    def on_success(self) -> None:
        with self._lock:
            self._tokens = min(self._tokens + self._credit, self._max)

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


class Attempt:
    """One iteration of a RetryPolicy loop. The caller runs its work, then
    either returns/breaks (done) or calls `retry()` — optionally with an
    explicit delay — to request another attempt."""

    __slots__ = ("index", "is_last", "deadline", "_retry", "_delay")

    def __init__(self, index: int, is_last: bool, deadline: Deadline):
        self.index = index
        self.is_last = is_last
        self.deadline = deadline
        self._retry = False
        self._delay: Optional[float] = None

    def retry(self, delay: Optional[float] = None) -> None:
        self._retry = True
        self._delay = delay

    def timeout(self, per_attempt: Optional[float]) -> Optional[float]:
        """Per-attempt timeout clamped to the policy's overall deadline."""
        return self.deadline.clamp(per_attempt)


class RetryPolicy:
    """Jittered-exponential-backoff retry loop with an overall deadline and
    an optional shared retry budget:

        for attempt in policy.attempts():
            try:
                resp = do_work(timeout=attempt.timeout(60.0))
            except TransientError:
                attempt.retry()
                continue
            return resp
        # attempts/deadline/budget exhausted
    """

    def __init__(self, max_attempts: int = 3, backoff: float = 0.1,
                 backoff_factor: float = 2.0, max_backoff: float = 30.0,
                 jitter: float = 0.1, deadline: Optional[float] = None,
                 retry_on: tuple = (Exception,),
                 budget: Optional[RetryBudget] = None,
                 rng: Optional[random.Random] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 metrics=None, metric_name: str = tnames.RETRY_RETRIES):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter is a fraction in [0, 1]")
        self.max_attempts = max_attempts
        self.backoff = backoff
        self.backoff_factor = backoff_factor
        self.max_backoff = max_backoff
        self.jitter = jitter
        self.deadline = deadline
        self.retry_on = retry_on
        self.budget = budget
        self._rng = rng
        self._sleep = sleep
        self._clock = clock
        self._metrics = metrics if metrics is not None else reliability_metrics
        self._metric_name = metric_name

    # -- schedule ------------------------------------------------------------
    def delay_for(self, attempt_index: int) -> float:
        """Backoff before attempt `attempt_index + 1`, jittered ±jitter."""
        base = min(self.backoff * (self.backoff_factor ** attempt_index),
                   self.max_backoff)
        if self.jitter:
            rng = self._rng if self._rng is not None else random
            base *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(base, 0.0)

    def _exhausted(self, index: int, deadline: Deadline) -> bool:
        if index + 1 >= self.max_attempts or deadline.expired():
            return True
        return self.budget is not None and not self.budget.can_retry()

    def attempts(self):
        deadline = Deadline.after(self.deadline, self._clock)
        index = 0
        while True:
            att = Attempt(index, self._exhausted(index, deadline), deadline)
            yield att
            if not att._retry or att.is_last:
                return
            if self.budget is not None and not self.budget.on_retry():
                return
            delay = att._delay if att._delay is not None \
                else self.delay_for(index)
            delay = min(delay, deadline.remaining())
            if delay > 0:
                self._sleep(delay)
            if deadline.expired():
                return
            self._metrics.inc(self._metric_name)
            index += 1

    # -- plain-exception convenience -----------------------------------------
    def call(self, fn: Callable[[], T], retry_on: Optional[tuple] = None,
             on_retry: Optional[Callable] = None) -> T:
        """Run fn() under the policy, retrying on `retry_on` exceptions.
        Raises the last error when the policy is exhausted."""
        retry_on = retry_on if retry_on is not None else self.retry_on
        last: Optional[BaseException] = None
        for att in self.attempts():
            try:
                out = fn()
            except retry_on as e:  # noqa: PERF203 - retry loop by design
                last = e
                if on_retry is not None:
                    on_retry(att, e)
                att.retry()
                continue
            if self.budget is not None:
                self.budget.on_success()
            return out
        assert last is not None
        raise last


class CircuitOpenError(RuntimeError):
    """Raised by CircuitBreaker.call when the circuit is open."""


class CircuitBreaker:
    """Closed/open/half-open breaker over a sliding outcome window.

    Trips OPEN when the last `window` outcomes hold at least
    `failure_threshold` failures AND the failure fraction reaches
    `failure_rate`. After `reset_timeout` seconds one half-open probe is
    allowed: success closes the circuit, failure re-opens it. Trips are
    counted in `reliability.metrics` under `<name>.trips`."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5, failure_rate: float = 0.5,
                 window: int = 20, reset_timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 metrics=None, name: str = "breaker"):
        self.failure_threshold = failure_threshold
        self.failure_rate = failure_rate
        self.window = window
        self.reset_timeout = reset_timeout
        self.name = name
        self._clock = clock
        self._metrics = metrics if metrics is not None else reliability_metrics
        self._lock = threading.Lock()
        self._outcomes: list = []   # rolling 0/1 failure flags, len<=window
        self._state = self.CLOSED
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.reset_timeout):
            self._state = self.HALF_OPEN
            self._probing = False
        return self._state

    def allow(self) -> bool:
        """May a call proceed right now? Half-open admits ONE probe."""
        with self._lock:
            state = self._state_locked()
            if state == self.CLOSED:
                return True
            if state == self.HALF_OPEN and not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state_locked() == self.HALF_OPEN:
                self._state = self.CLOSED
                self._outcomes.clear()
                self._probing = False
                return
            self._push(0)

    def record_failure(self) -> None:
        with self._lock:
            state = self._state_locked()
            if state == self.HALF_OPEN:
                self._trip()
                return
            if state == self.OPEN:
                return
            self._push(1)
            fails = sum(self._outcomes)
            if (fails >= self.failure_threshold
                    and fails / len(self._outcomes) >= self.failure_rate):
                self._trip()

    def _push(self, outcome: int) -> None:
        self._outcomes.append(outcome)
        if len(self._outcomes) > self.window:
            del self._outcomes[0]

    def _trip(self) -> None:
        self._state = self.OPEN
        self._opened_at = self._clock()
        self._probing = False
        self._outcomes.clear()
        self._metrics.inc(tnames.breaker_trips(self.name))

    def call(self, fn: Callable[[], T]) -> T:
        """Gate fn() through the breaker: CircuitOpenError without calling
        when open; outcomes recorded otherwise."""
        if not self.allow():
            raise CircuitOpenError(
                f"circuit {self.name!r} is {self.state}")
        try:
            out = fn()
        except Exception:
            self.record_failure()
            raise
        self.record_success()
        return out
