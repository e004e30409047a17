"""Progressive delivery: staged candidate rollout with chaos-proven
auto-rollback.

Port of the reference's `control/rollout.py` (host Python over the port's
serving, registry and telemetry). The rollback *signal* is the canary
gauges, `canary_objectives` burn verdicts and `canary_watch_rules` trips;
`RolloutDriver` is the actuation: it `install_model`s a candidate on a
configurable traffic fraction of workers, polls the fleet
(`scrape_cluster(versions=True, slo=True)`), and drives a DETERMINISTIC
state machine —

    pending --start()--> canary[step 0] --healthy xN--> canary[step 1]
        ... --healthy xN--> soak --healthy xM--> promoted
    canary/soak --burn or watch trip--> rolling_back --> rolled_back
                                 (rollback exhausted) --> failed

— auto-promoting through the staged path or auto-rolling-back via
re-`install_model` of the incumbent. Every transition is journaled to
the RunLedger (file order pins `deploy < burn < rollback < recovered`)
and emitted as a `control.rollout.*` event.

The state machine (`RolloutStateMachine`) is a PURE function of its
observations: no sockets, no clocks — seeded observation schedules drive
every transition in tests. The driver wraps it with the fleet I/O:
scraping (chaos site `control.rollout.poll`), installs, and the
retry-bounded (`reliability.RetryPolicy`), IDEMPOTENT rollback — a
double rollback is a no-op, and a rollback racing the seeded
`serving.swap` fault retries until the incumbent serves again.
"""
from __future__ import annotations

import math
import time
from collections import deque
from typing import NamedTuple, Optional

from ..reliability.metrics import reliability_metrics
from ..reliability.policy import RetryPolicy
from ..telemetry import names as tnames
from ..telemetry.slo import verdict_burning
from ..telemetry.spans import get_tracer
from ..telemetry.watch import evaluate_rule

# -- states (module constants so tests read like the diagram) -------------
PENDING = "pending"
CANARY = "canary"
SOAK = "soak"
PROMOTED = "promoted"
ROLLING_BACK = "rolling_back"
ROLLED_BACK = "rolled_back"
FAILED = "failed"


class RolloutConfig(NamedTuple):
    """Rollout knobs.

    `traffic_steps` are ascending worker-fraction stages ending at 1.0;
    `step_polls` healthy observations clear one stage, `soak_polls` more
    at full traffic auto-promote. `recover_polls` bounds the
    post-rollback wait for the fleet verdict to return to ok."""
    traffic_steps: tuple = (0.25, 0.5, 1.0)
    step_polls: int = 2
    soak_polls: int = 3
    poll_interval_s: float = 1.0
    scrape_window_s: Optional[float] = 60.0
    recover_polls: int = 60
    history: int = 64   # retained merged-metric samples for watch rules


class Observation(NamedTuple):
    """One poll round's verdict, reduced to what the machine keys on."""
    burning: bool = False     # fleet or candidate SLO error budget burning
    tripped: bool = False     # a canary watch rule breached
    detail: Optional[dict] = None

    @property
    def healthy(self) -> bool:
        return not (self.burning or self.tripped)


class Action(NamedTuple):
    """What the machine asks the driver to do next."""
    kind: str                          # install | promote | rollback
    fraction: Optional[float] = None   # install: target worker fraction
    reason: Optional[str] = None       # rollback: burn | watch-trip


class RolloutStateMachine:
    """The pure transition core: feed observations, get actions.

    Deterministic and I/O-free — the same observation sequence always
    produces the same action sequence, so seeded schedules pin every
    transition without sockets."""

    def __init__(self, config: Optional[RolloutConfig] = None):
        config = config if config is not None else RolloutConfig()
        steps = tuple(float(f) for f in config.traffic_steps)
        if not steps or steps[-1] != 1.0:
            raise ValueError("traffic_steps must end at 1.0 (full traffic)")
        if any(b <= a for a, b in zip(steps, steps[1:])) \
                or steps[0] <= 0.0:
            raise ValueError("traffic_steps must be ascending in (0, 1]")
        if config.step_polls < 1 or config.soak_polls < 0:
            raise ValueError("step_polls >= 1 and soak_polls >= 0 required")
        self.config = config._replace(traffic_steps=steps)
        self.state = PENDING
        self.step = -1            # index into traffic_steps
        self._healthy = 0         # consecutive healthy polls this stage

    @property
    def fraction(self) -> float:
        """The traffic fraction currently targeted for the candidate."""
        if self.state in (PENDING, ROLLING_BACK, ROLLED_BACK, FAILED):
            return 0.0
        if self.state in (SOAK, PROMOTED):
            return 1.0
        return self.config.traffic_steps[self.step]

    def start(self) -> Action:
        if self.state != PENDING:
            raise RuntimeError(f"rollout already started (state={self.state})")
        self.state = CANARY
        self.step = 0
        self._healthy = 0
        return Action("install", fraction=self.config.traffic_steps[0])

    def on_observation(self, obs: Observation) -> Optional[Action]:
        """One poll round. Returns the action to take, or None (keep
        watching). Observations landing in a terminal state — or during
        a rollback already in flight — are inert, which is half of the
        double-rollback idempotency (the driver's installed-set is the
        other half)."""
        if self.state not in (CANARY, SOAK):
            return None
        if not obs.healthy:
            self.state = ROLLING_BACK
            self._healthy = 0
            return Action("rollback",
                          reason="burn" if obs.burning else "watch-trip")
        self._healthy += 1
        if self.state == CANARY:
            if self._healthy >= self.config.step_polls:
                self._healthy = 0
                if self.step + 1 < len(self.config.traffic_steps):
                    self.step += 1
                    return Action(
                        "install",
                        fraction=self.config.traffic_steps[self.step])
                self.state = SOAK
            return None
        if self._healthy >= self.config.soak_polls:
            self.state = PROMOTED
            return Action("promote")
        return None

    def on_rollback_result(self, ok: bool) -> None:
        """Commit the rollback outcome. Idempotent: only a rollback in
        flight transitions; a second call (double rollback) is a no-op."""
        if self.state == ROLLING_BACK:
            self.state = ROLLED_BACK if ok else FAILED


class RolloutDriver:
    """The I/O wrapper: installs, fleet scrapes, journals, retries.

    `workers` maps a stable worker name to its serving transform (the
    object `serve_pipeline` mounts — anything with `install_model(model,
    if_changed=...)` and a `version`). Order is the install order: the
    first `ceil(fraction * N)` workers carry the candidate at each step,
    so a given fraction always names the same workers.

    `observe` (tests) replaces the fleet scrape with any callable
    returning an `Observation` (or None for "scrape failed, skip the
    round"); `registry_address` arms the real scrape path. `ledger`
    defaults to the configured run ledger (may be None: events still
    emit, journaling is skipped). `faults` arms the `control.rollout.poll`
    chaos site; the `serving.swap` site fires inside each transform's own
    injector during (re-)installs.

    `candidate` may be a model or a zero-arg callable producing one
    (candidate-source hook): the callable is resolved at construction so
    the driver's content-addressed `candidate_version` names the exact
    artifact the rollout ships."""

    def __init__(self, workers, incumbent, candidate,
                 registry_address: Optional[str] = None,
                 config: Optional[RolloutConfig] = None,
                 observe=None, ledger=None, faults=None,
                 rollback_policy: Optional[RetryPolicy] = None,
                 scrape_timeout: float = 5.0,
                 clock=time.monotonic, sleep=time.sleep, metrics=None):
        self._workers = list(workers.items()) if isinstance(workers, dict) \
            else [(name, t) for name, t in workers]
        if not self._workers:
            raise ValueError("need at least one worker")
        if registry_address is None and observe is None:
            raise ValueError("need registry_address (fleet scrape) or "
                             "observe (injected observations)")
        self.machine = RolloutStateMachine(config)
        self.config = self.machine.config
        self.registry_address = registry_address
        self.incumbent = incumbent
        # candidate-source hook: a zero-arg callable is resolved here,
        # once — so continuous-learning producers (online.loop) can hand
        # the driver a "build my freshest candidate" thunk and the
        # content-addressed version below names what actually ships
        if callable(candidate) and not hasattr(candidate, "transform"):
            candidate = candidate()
        self.candidate = candidate
        self._observe_fn = observe
        self.scrape_timeout = scrape_timeout
        self._clock = clock
        self._sleep = sleep
        self._faults = faults
        self._metrics = metrics if metrics is not None \
            else reliability_metrics
        if ledger is None:
            from ..telemetry.lineage import get_run_ledger
            ledger = get_run_ledger()
        self._ledger = ledger
        self._rollback_policy = rollback_policy if rollback_policy \
            is not None else RetryPolicy(
                max_attempts=4, backoff=0.05, backoff_factor=2.0,
                max_backoff=0.5, jitter=0.0, sleep=sleep,
                metric_name=tnames.CONTROL_ROLLOUT_ROLLBACK_RETRIES)
        self._candidate_on: set = set()   # worker names serving candidate
        self._rolled_back = False
        from ..telemetry.lineage import canary_watch_rules, model_version
        self._watch_rules = canary_watch_rules()
        self._history: deque = deque(maxlen=max(int(self.config.history), 8))
        self.candidate_version = model_version(candidate).version
        self.incumbent_version = model_version(incumbent).version
        if self.candidate_version == self.incumbent_version:
            raise ValueError("candidate and incumbent are the same version")

    # -- journaling -----------------------------------------------------------
    def _journal(self, event: str, **attrs) -> None:
        get_tracer().event(event, **attrs)
        if self._ledger is not None:
            self._ledger.append_event(
                event, candidate=self.candidate_version,
                incumbent=self.incumbent_version, **attrs)

    # -- observation ----------------------------------------------------------
    def _observe(self) -> Optional[Observation]:
        if self._observe_fn is not None:
            return self._observe_fn()
        try:
            if self._faults is not None:
                self._faults.perturb("control.rollout.poll")
            from ..telemetry.exposition import scrape_cluster
            snap = scrape_cluster(self.registry_address, slo=True,
                                  versions=True,
                                  timeout=self.scrape_timeout,
                                  window=self.config.scrape_window_s)
        except Exception:  # noqa: BLE001 - a failed scrape skips the round
            self._metrics.inc(tnames.CONTROL_ROLLOUT_POLL_ERRORS)
            return None
        burning = verdict_burning(snap.slo)
        by_version = (snap.versions or {}).get("slo_by_version") or {}
        burning = burning or verdict_burning(
            by_version.get(self.candidate_version))
        self._history.append((self._clock(), snap.merged))
        tripped, trip = False, None
        for rule in self._watch_rules:
            series = [(t, m[rule.key]) for t, m in self._history
                      if rule.key in m]
            trip = evaluate_rule(rule, series)
            if trip is not None:
                tripped = True
                break
        return Observation(burning=burning, tripped=tripped,
                           detail={"trip": trip} if trip else None)

    # -- actuation ------------------------------------------------------------
    def _install_fraction(self, fraction: float) -> list:
        """Install the candidate on the first ceil(fraction*N) workers
        not already carrying it. A failed candidate install triggers an
        immediate rollback (the candidate could not even deploy)."""
        n = len(self._workers)
        # ceil with a float-slop guard: 0.5 * 4 must be 2 workers, not 3
        want = min(n, max(1, math.ceil(fraction * n - 1e-9)))
        fresh = []
        for name, transform in self._workers[:want]:
            if name in self._candidate_on:
                continue
            transform.install_model(self.candidate)
            self._candidate_on.add(name)
            fresh.append(name)
        self._metrics.inc(tnames.CONTROL_ROLLOUT_STEPS)
        self._metrics.set_gauge(tnames.CONTROL_ROLLOUT_FRACTION, fraction)
        return fresh

    def rollback(self, reason: str = "manual") -> bool:
        """Re-install the incumbent on every worker carrying the
        candidate. IDEMPOTENT: a second call returns immediately (the
        installed-set is empty and the journal/counters are untouched);
        per-worker installs use `if_changed=True`, so even a re-driven
        rollback cannot double-swap a worker. Retry-bounded: each
        worker's re-install runs under the driver's RetryPolicy — a
        `serving.swap` fault mid-rollback retries until the incumbent
        serves (True) or the policy exhausts (False, state `failed`)."""
        if self._rolled_back:
            return True
        self._rolled_back = True
        if self.machine.state != ROLLING_BACK:
            # direct/manual rollback: take the machine there first so the
            # outcome transition below lands (inert if already terminal)
            self.machine.state = ROLLING_BACK
        targets = sorted(self._candidate_on)
        ok = True
        for name, transform in self._workers:
            if name not in self._candidate_on:
                continue
            if self._rollback_worker(transform):
                self._candidate_on.discard(name)
            else:
                ok = False
        self._metrics.inc(tnames.CONTROL_ROLLOUT_ROLLBACKS)
        self._metrics.set_gauge(tnames.CONTROL_ROLLOUT_FRACTION, 0.0)
        self.machine.on_rollback_result(ok)
        self._journal(tnames.CONTROL_ROLLOUT_ROLLBACK_EVENT, reason=reason,
                      ok=ok, workers=targets)
        return ok

    def _rollback_worker(self, transform) -> bool:
        last: Optional[Exception] = None
        for att in self._rollback_policy.attempts():
            try:
                transform.install_model(self.incumbent, if_changed=True)
                return True
            except Exception as e:  # noqa: BLE001 - retried under policy
                last = e
                att.retry()
        del last
        return False

    # -- the loop -------------------------------------------------------------
    def run(self) -> dict:
        """Drive the rollout to a terminal state; returns `status()`.
        Synchronous — run it on its own thread next to live load (the
        fleet bench does) or inline in tests with injected observe/sleep."""
        action = self.machine.start()
        # deploy is journaled FIRST — even a candidate that cannot
        # install keeps the pinned ledger order deploy < burn < rollback
        self._journal(tnames.CONTROL_ROLLOUT_DEPLOY_EVENT,
                      fraction=action.fraction)
        self._install_or_rollback(action)
        while self.machine.state in (CANARY, SOAK):
            self._sleep(self.config.poll_interval_s)
            obs = self._observe()
            if obs is None:
                continue
            action = self.machine.on_observation(obs)
            if action is None:
                continue
            if action.kind == "install":
                self._install_or_rollback(action)
            elif action.kind == "promote":
                self._metrics.inc(tnames.CONTROL_ROLLOUT_PROMOTIONS)
                self._journal(tnames.CONTROL_ROLLOUT_PROMOTE_EVENT)
            elif action.kind == "rollback":
                detail = (obs.detail or {}) if obs is not None else {}
                self._journal(tnames.CONTROL_ROLLOUT_BURN_EVENT,
                              reason=action.reason, **detail)
                self.rollback(reason=action.reason)
                self._await_recovery()
        return self.status()

    def _install_or_rollback(self, action: Action):
        """Run one install step; a deploy failure (the candidate can't
        even install — e.g. its `serving.swap` chaos fired) rolls back
        whatever fraction already carries it."""
        try:
            fresh = self._install_fraction(action.fraction)
            self._journal(tnames.CONTROL_ROLLOUT_STEP_EVENT,
                          fraction=action.fraction, workers=fresh)
            return fresh
        except Exception as e:  # noqa: BLE001 - deploy failure => rollback
            self.machine.state = ROLLING_BACK
            self._journal(tnames.CONTROL_ROLLOUT_BURN_EVENT,
                          reason="deploy-failure", error=str(e))
            self.rollback(reason="deploy-failure")
            self._await_recovery()
            return None

    def _await_recovery(self) -> None:
        """Post-rollback: poll until the fleet verdict reads healthy
        again (bounded by recover_polls), then journal `recovered`."""
        ok = False
        for _ in range(max(int(self.config.recover_polls), 0)):
            obs = self._observe()
            if obs is not None and obs.healthy:
                ok = True
                break
            self._sleep(self.config.poll_interval_s)
        self._journal(tnames.CONTROL_ROLLOUT_RECOVERED_EVENT, ok=ok)

    def status(self) -> dict:
        return {"state": self.machine.state,
                "step": self.machine.step,
                "fraction": self.machine.fraction,
                "candidate": self.candidate_version,
                "incumbent": self.incumbent_version,
                "candidate_on": sorted(self._candidate_on)}
