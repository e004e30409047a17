"""SLO-burn-aware fleet actuators: the knobs the control loop turns.

Port of the reference's `control/actuators.py` (host Python over the
port's `RegistryClient`, `ServingServer` and SLO engine).

Three actuators, one per layer of the serving stack:

- `WeightedRouter` — the ROUTING tier. A `RegistryClient` whose target
  selection is smooth-weighted-round-robin over per-worker weights
  derived from the fleet scrape (queue depth x windowed p99): a worker
  whose queue grows or whose tail stretches sees its share of new
  requests drop, instead of the blind rotation feeding it at full rate
  until it trips the SLO.
- `BurnAwareAdmission` — the ADMISSION tier. `ServingServer` consults it
  at enqueue: while the error budget burns, excess load is shed with
  503 + Retry-After BEFORE it queues (shed-before-queue), so a burning
  worker's queue depth stays bounded instead of absorbing the backlog
  that keeps its p99 pinned past the objective. The verdict is cached
  (`refresh_s`) so the hot path never pays an SLO evaluation per request.
- `FleetScaler` — the FLEET tier. Pure occupancy-driven spawn/drain
  decisions (`decide`) plus a cooldown-debounced stateful wrapper
  (`observe`) that fires caller-provided hooks; the hooks are the
  existing per-worker lifecycle (`serve_pipeline` up, graceful drain
  down), so the scaler stays policy, not mechanism.

All three are deterministic given their inputs (the SWRR rotation is a
pure function of the weight table; `decide` is a pure function of the
occupancy window) — seeded tests pin their behavior without load.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..reliability.metrics import reliability_metrics
from ..telemetry import names as tnames
from ..io.registry import RegistryClient

_DEFAULT_WEIGHT = 100   # weight of a worker the scrape hasn't costed yet


class WeightedRouter(RegistryClient):
    """RegistryClient with smooth-weighted-round-robin target selection.

    Weights are integers (share of new requests, relative); unknown
    targets default to 100, so an unweighted router IS the plain
    round-robin client. `update_from_scrape` turns a fleet
    `ClusterSnapshot` into weights with cost = (1 + queue_depth) x
    max(p99_ms, 1): the cheapest worker keeps weight 100 and a worker
    N times costlier gets ~100/N — a delay-faulted worker's share drops
    while the fleet keeps answering (the actuator acceptance).

    SWRR (nginx's algorithm): each pick adds every target's weight to
    its current credit, routes to the max, then subtracts the total —
    deterministic, starvation-free (any positive weight gets a turn),
    and maximally spread (no bursts of the heavy target back-to-back).
    """

    def __init__(self, registry_address: str, name: str,
                 refresh_every: int = 64, timeout: float = 30.0):
        # set before super().__init__: it calls refresh() -> _next_target
        # state must exist
        self._weights: dict = {}   # address -> int weight
        self._current: dict = {}   # address -> SWRR credit
        super().__init__(registry_address, name,
                         refresh_every=refresh_every, timeout=timeout)

    @property
    def weights(self) -> dict:
        with self._lock:
            return dict(self._weights)

    def set_weights(self, weights: dict) -> None:
        """Replace the weight table ({address: int}); floors at 1 (a
        zero/negative weight would starve the SWRR rotation — drain a
        worker by unregistering it, not by zeroing it)."""
        cleaned = {addr: max(1, int(w)) for addr, w in weights.items()}
        with self._lock:
            self._weights = cleaned
            # drop credit for departed targets; keep credit for survivors
            # so a weight refresh doesn't reset the rotation's spread
            self._current = {a: self._current.get(a, 0) for a in cleaned}
        reliability_metrics.inc(tnames.CONTROL_ROUTER_UPDATES)
        for addr, w in cleaned.items():
            reliability_metrics.set_gauge(
                tnames.control_router_weight(addr), float(w))

    def update_from_scrape(self, snapshot) -> dict:
        """Derive weights from a `scrape_cluster` ClusterSnapshot and
        install them. Returns the weight table (for tests/logging)."""
        from ..telemetry.exposition import state_snapshot
        costs = {}
        for info, state in snapshot.workers:
            flat = state_snapshot(state)
            depth = float(flat.get(tnames.SERVING_QUEUE_DEPTH, 0.0) or 0.0)
            p99 = float(
                flat.get(tnames.SERVING_REQUEST_E2E + ".p99", 0.0) or 0.0)
            costs[f"{info.host}:{info.port}"] = \
                (1.0 + max(depth, 0.0)) * max(p99, 1.0)
        if not costs:
            return {}
        floor = min(costs.values())
        weights = {addr: max(1, round(_DEFAULT_WEIGHT * floor / cost))
                   for addr, cost in costs.items()}
        self.set_weights(weights)
        return weights

    def _next_target(self):
        """SWRR pick over live targets; falls back to the base rotation
        when no weight table is installed."""
        with self._lock:
            live = [t for t in self._targets if t.address not in self._dead]
            if not live:
                return None
            if not self._weights:
                t = live[self._count % len(live)]
                self._count += 1
                return t
            total = 0
            best, best_credit = None, None
            for t in live:
                addr = f"{t.host}:{t.port}"
                w = self._weights.get(addr, _DEFAULT_WEIGHT)
                total += w
                credit = self._current.get(addr, 0) + w
                self._current[addr] = credit
                if best_credit is None or credit > best_credit:
                    best, best_credit = t, credit
            self._current[f"{best.host}:{best.port}"] -= total
            self._count += 1
            return best


class BurnAwareAdmission:
    """Shed-before-queue admission control for `ServingServer`.

    `should_shed(queue_depth)` is consulted at enqueue, BEFORE the
    max_queue check: it returns True when the SLO error budget is
    burning AND the partition queue already holds more than
    `queue_allowance` requests — the request is answered 503 with
    `Retry-After: retry_after_s` instead of queueing behind a backlog
    the worker demonstrably can't drain inside its objective. In-flight
    and under-allowance requests still queue, so a short burn sheds the
    excess, not the service.

    The burn verdict is CACHED: `verdict_fn` (default: this process's
    SLO engine, `get_engine().verdict()`) runs at most once
    per `refresh_s` — the serving hot path pays a monotonic-clock read
    and a bool, never an SLO evaluation. A verdict_fn that raises reads
    as not-burning (fail open: admission must never take down a healthy
    worker)."""

    def __init__(self, verdict_fn: Optional[Callable] = None,
                 refresh_s: float = 0.25, retry_after_s: float = 1.0,
                 queue_allowance: int = 0, clock=time.monotonic):
        if verdict_fn is None:
            def verdict_fn():
                from ..telemetry.slo import get_engine
                return get_engine().verdict()
        self._verdict_fn = verdict_fn
        self.refresh_s = float(refresh_s)
        self.retry_after_s = float(retry_after_s)
        self.queue_allowance = int(queue_allowance)
        self._clock = clock
        self._lock = threading.Lock()
        self._burning = False
        self._stamp: Optional[float] = None

    def burning(self) -> bool:
        """The cached burn verdict, refreshed at most every refresh_s."""
        now = self._clock()
        with self._lock:
            if self._stamp is not None \
                    and now - self._stamp < self.refresh_s:
                return self._burning
            self._stamp = now
        try:
            verdict = self._verdict_fn()
        except Exception:  # noqa: BLE001 - fail open
            verdict = None
        from ..telemetry.slo import verdict_burning
        burning = verdict_burning(verdict)
        with self._lock:
            self._burning = burning
        return burning

    def should_shed(self, queue_depth: int) -> bool:
        return queue_depth > self.queue_allowance and self.burning()


class FleetScaler:
    """Occupancy-driven worker count policy: spawn when the fleet runs
    hot for a full window, drain when it runs cold — mechanism stays
    with the caller (`spawn`/`drain` hooks, e.g. `serve_pipeline` /
    graceful drain).

    `decide` is PURE: given the last-`window` occupancy samples (0..1,
    e.g. fleet batch occupancy or queue_depth/max_queue) and the worker
    count, it returns "spawn", "drain", or None. `observe` wraps it with
    the stateful parts — sample accumulation and a `cooldown`-round
    debounce so one scale action settles before the next fires."""

    def __init__(self, spawn: Optional[Callable] = None,
                 drain: Optional[Callable] = None,
                 high: float = 0.75, low: float = 0.15,
                 window: int = 3, cooldown: int = 2,
                 min_workers: int = 1,
                 max_workers: Optional[int] = None):
        if not 0.0 <= low < high <= 1.0:
            raise ValueError("need 0 <= low < high <= 1")
        self.spawn_hook = spawn
        self.drain_hook = drain
        self.high = float(high)
        self.low = float(low)
        self.window = max(1, int(window))
        self.cooldown = max(0, int(cooldown))
        self.min_workers = max(1, int(min_workers))
        self.max_workers = max_workers
        self._samples: list = []
        self._cooldown_left = 0

    def decide(self, occupancy_series, n_workers: int) -> Optional[str]:
        """Pure policy: a full window above `high` (and room to grow)
        says spawn; a full window at/below `low` (and room to shrink)
        says drain; anything else holds."""
        series = list(occupancy_series)[-self.window:]
        if len(series) < self.window:
            return None
        if all(s >= self.high for s in series) \
                and (self.max_workers is None
                     or n_workers < self.max_workers):
            return "spawn"
        if all(s <= self.low for s in series) \
                and n_workers > self.min_workers:
            return "drain"
        return None

    def observe(self, occupancy: float, n_workers: int) -> Optional[str]:
        """Feed one fleet occupancy sample; fires the matching hook when
        the windowed policy says so (debounced by `cooldown` rounds).
        Returns the action taken, or None."""
        self._samples.append(float(occupancy))
        del self._samples[:-self.window]
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            return None
        action = self.decide(self._samples, n_workers)
        if action is None:
            return None
        self._samples.clear()     # a scale action invalidates the window
        self._cooldown_left = self.cooldown
        if action == "spawn":
            reliability_metrics.inc(tnames.CONTROL_SCALER_SPAWNS)
            if self.spawn_hook is not None:
                self.spawn_hook()
        else:
            reliability_metrics.inc(tnames.CONTROL_SCALER_DRAINS)
            if self.drain_hook is not None:
                self.drain_hook()
        return action
