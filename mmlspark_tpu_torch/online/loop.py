"""ContinuousLearner: the loop that closes.

Port of the reference's `online/loop.py` (host Python; the learner it
drives updates on the card).

```
            ┌────────────────────────────────────────────────┐
            v                                                │
  WATCHING ──trigger (drift trip | floor burn, pairs>=min)──┐│
            │                                               ││
            │                REFITTING                      ││
            │   snapshot -> drain feed -> partial_fit       ││
            │   -> [online.refit chaos site] -> candidate   ││
            │   (a raise rewinds the snapshot and retries)  ││
            │                                               v│
            │                CANARYING                       │
            │   deploy(candidate) -> rollout gate            │
            │     promoted  -> journal online.promote  ──────┘
            │     rejected  -> rewind snapshot,
            │                  journal online.rollback ──────┘
```

The policy is a pure state machine in the `RolloutStateMachine`
discipline: `ContinuousLearnerMachine` sees observations and returns
actions, does no I/O, holds no clock — exhaustively testable in
microseconds. `ContinuousLearner` wraps it with the impure halves
(feed drain, learner updates, ledger journaling, the deploy callable)
and pins the ledger event order every cycle journals:

    online.trip < online.refit < online.deploy <
        (online.promote | online.rollback)

Refits are retry-bounded (`online.refit_retries`) and every attempt
starts from the pre-refit snapshot, so a crashed attempt leaves no
partial update behind and a retry converges to the same weights — the
`online.refit` chaos site proves it. The incumbent keeps serving
through all of it: nothing installs until the candidate exists, and
the rollout gate owns install/promote/rollback from there.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

from ..reliability.metrics import reliability_metrics
from ..reliability.policy import RetryPolicy
from ..telemetry import names as tnames
from ..telemetry.spans import get_tracer

WATCHING = "watching"
REFITTING = "refitting"
CANARYING = "canarying"


class OnlineConfig(NamedTuple):
    """Loop knobs."""
    min_pairs: int = 64          # don't refit on a trickle
    max_refit_rows: int = 4096   # one refit's drain bound
    max_drift: float = 0.25      # PSI ceiling for the default observer
    poll_interval_s: float = 0.5
    cooldown_polls: int = 2      # quiet polls required after an outcome


class OnlineObservation(NamedTuple):
    """What the policy sees: trigger signals + buffered-pair depth."""
    drift_tripped: bool = False
    floor_burning: bool = False
    pairs: int = 0
    detail: Optional[dict] = None

    @property
    def triggered(self) -> bool:
        return self.drift_tripped or self.floor_burning


class OnlineAction(NamedTuple):
    kind: str                    # "refit" | "deploy"
    reason: Optional[str] = None


class ContinuousLearnerMachine:
    """Pure policy: observation in, action out, no I/O, no clock."""

    def __init__(self, config: Optional[OnlineConfig] = None):
        self.config = config or OnlineConfig()
        self.state = WATCHING
        self.last_outcome: Optional[str] = None
        self._cooldown = 0

    def on_observation(self, obs: OnlineObservation
                       ) -> Optional[OnlineAction]:
        if self.state != WATCHING:
            return None
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        if obs.triggered and obs.pairs >= self.config.min_pairs:
            self.state = REFITTING
            reason = "drift" if obs.drift_tripped else "floor-burn"
            return OnlineAction("refit", reason=reason)
        return None

    def on_refit_result(self, ok: bool) -> Optional[OnlineAction]:
        if self.state != REFITTING:
            return None
        if not ok:
            self.state = WATCHING
            self._cooldown = self.config.cooldown_polls
            self.last_outcome = "refit-failed"
            return None
        self.state = CANARYING
        return OnlineAction("deploy")

    def on_rollout_result(self, promoted: bool) -> None:
        if self.state != CANARYING:
            return
        self.state = WATCHING
        self._cooldown = self.config.cooldown_polls
        self.last_outcome = "promoted" if promoted else "rolled-back"


class ContinuousLearner:
    """The impure wrapper: drives the machine against real signals.

    Parameters
    ----------
    learner:  `OnlineLearner` holding the incremental training state.
    feed:     `LabelFeed` of joined (features, label, weight) pairs.
    deploy:   `fn(model) -> bool` — hand the candidate to the rollout
              gate (typically a `RolloutDriver` run; see
              `control.rollout`'s candidate-source hook) and report
              whether it promoted. A raise counts as a rejection.
    observe:  `fn() -> OnlineObservation`; defaults to reading the
              quality monitor's drift state + the feed depth.
    features_col / prediction_col: stamped onto produced candidates —
              must match the serving transform's columns.
    """

    def __init__(self, learner, feed,
                 deploy: Callable[[object], bool],
                 observe: Optional[Callable[[], OnlineObservation]] = None,
                 config: Optional[OnlineConfig] = None,
                 ledger=None, faults=None,
                 refit_policy: Optional[RetryPolicy] = None,
                 features_col: str = "features",
                 prediction_col: str = "prediction",
                 metrics=None, sleep=time.sleep):
        self.learner = learner
        self.feed = feed
        self.machine = ContinuousLearnerMachine(config)
        self.config = self.machine.config
        self._deploy = deploy
        self._observe = observe if observe is not None \
            else self._default_observe
        self._ledger = ledger
        self._faults = faults
        self._metrics = metrics if metrics is not None \
            else reliability_metrics
        self._sleep = sleep
        self.features_col = features_col
        self.prediction_col = prediction_col
        self._refit_policy = refit_policy if refit_policy is not None \
            else RetryPolicy(max_attempts=3, backoff=0.01,
                             backoff_factor=2.0, max_backoff=0.1,
                             jitter=0.0, sleep=sleep,
                             metric_name=tnames.ONLINE_REFIT_RETRIES,
                             metrics=self._metrics)
        self.cycles = 0

    # -- signals --------------------------------------------------------------
    def _default_observe(self) -> OnlineObservation:
        """Drift trip from the live quality monitor + floor burn from the
        process SLO engine's windowed verdict (telemetry/slo.py): an
        objective burning in BOTH its short and long windows — e.g. a
        quality-metric floor via `quality_objectives(metric_floor=...)` —
        flips `floor_burning`, so a model whose live metric sinks below
        the floor refits even when its feature distributions never
        drifted. The engine's no-data rule ("absence of evidence is not a
        burn") keeps an unconfigured or idle engine from false-tripping.
        An injected observer remains the test seam for both signals."""
        from ..telemetry import quality as tquality
        mon = tquality.get_monitor()
        worst, worst_col = 0.0, None
        if mon.active:
            for col, row in mon.drift().items():
                psi = row.get("psi")
                if (psi is not None
                        and row.get("live_count", 0) >= mon.min_live
                        and psi > worst):
                    worst, worst_col = float(psi), col
        tripped = worst > self.config.max_drift
        detail = ({"psi": round(worst, 4), "col": worst_col}
                  if tripped else None)
        burning = False
        try:
            from ..telemetry import slo as tslo
            verdict = tslo.get_engine().verdict()
            hot = sorted(o["objective"]["name"]
                         for o in verdict.get("objectives", ())
                         if o.get("burning"))
            burning = bool(hot)
            if burning and detail is None:
                detail = {"slo": hot}
        except Exception:  # noqa: BLE001 - observation must not kill the loop
            burning = False
        return OnlineObservation(drift_tripped=tripped,
                                 floor_burning=burning,
                                 pairs=len(self.feed), detail=detail)

    def _journal(self, event: str, **attrs) -> None:
        get_tracer().event(event, **attrs)
        if self._ledger is not None:
            self._ledger.append_event(event, **attrs)

    # -- the refit ------------------------------------------------------------
    def _refit(self, snap: dict, reason: str):
        """Retry-bounded incremental refit. Every attempt rewinds to
        the pre-refit snapshot first, so the fault path leaves no
        partial update and retries converge to identical weights. The
        `online.refit` chaos site fires between the minibatch updates
        and candidate construction — mid-refit, state already dirty."""
        batch = self.feed.take(self.config.max_refit_rows)
        if batch is None:
            raise RuntimeError("label feed drained empty at refit time")
        idx, val, y, w = batch
        last_err: Optional[Exception] = None
        for att in self._refit_policy.attempts():
            self.learner.restore(snap)
            try:
                stats = self.learner.partial_fit(idx, val, y, w)
                if self._faults is not None:
                    self._faults.perturb("online.refit")
                reference = self._reference_profile(idx, val)
                model = self.learner.make_model(
                    features_col=self.features_col,
                    prediction_col=self.prediction_col,
                    reference_profile=reference, reason=reason)
                return model, stats
            except Exception as e:  # noqa: BLE001 - rewind, maybe retry
                last_err = e
                if att.is_last:
                    break
                att.retry()
        self.learner.restore(snap)
        raise last_err

    def _reference_profile(self, idx, val) -> Optional[dict]:
        """Fresh drift reference from the candidate's own scores on the
        refit sample — installing it re-baselines the drift gauges so a
        healed model doesn't keep tripping on the incumbent's frozen
        profile. Never fails the refit."""
        try:
            import numpy as np

            from ..telemetry.quality import DatasetProfile
            link = ("logistic"
                    if self.learner.params.loss_function == "logistic"
                    else None)
            score = self.learner.predict(idx, val, link=link)
            pred = ((score > 0.5).astype(np.float64)
                    if link == "logistic" else score.astype(np.float64))
            prof = DatasetProfile.fit({"prediction": pred})
            return prof.state()
        except Exception:  # noqa: BLE001 - reference is best-effort
            return None

    # -- one cycle ------------------------------------------------------------
    def run_once(self) -> dict:
        """One observation -> (maybe) one full trip/refit/deploy cycle.
        Returns a status dict; never raises on refit or deploy failure
        (those are outcomes, counted and journaled)."""
        obs = self._observe()
        action = self.machine.on_observation(obs)
        if action is None:
            return {"state": self.machine.state, "action": None,
                    "pairs": obs.pairs}
        self.cycles += 1
        self._metrics.inc(tnames.ONLINE_TRIPS)
        self._journal(tnames.ONLINE_TRIP_EVENT, reason=action.reason,
                      pairs=obs.pairs, **(obs.detail or {}))
        snap = self.learner.snapshot()
        try:
            model, stats = self._refit(snap, action.reason)
        except Exception as e:  # noqa: BLE001 - refit failed: stay put
            self.machine.on_refit_result(False)
            return {"state": self.machine.state, "action": "refit",
                    "outcome": "refit-failed", "error": str(e)}
        from ..telemetry.lineage import model_version
        version = model_version(model, content=True).version
        self._metrics.inc(tnames.ONLINE_REFITS)
        self._journal(tnames.ONLINE_REFIT_EVENT, version=version,
                      updates=stats["updates"],
                      examples=stats["examples"],
                      loss=round(stats["loss"], 6))
        self.machine.on_refit_result(True)
        self._journal(tnames.ONLINE_DEPLOY_EVENT, version=version)
        try:
            promoted = bool(self._deploy(model))
        except Exception:  # noqa: BLE001 - a raising gate is a rejection
            promoted = False
        if promoted:
            self._metrics.inc(tnames.ONLINE_PROMOTIONS)
            self._journal(tnames.ONLINE_PROMOTE_EVENT, version=version)
        else:
            # rejected candidate: the gate already restored the
            # incumbent fleet-side; rewind the learner to match
            self.learner.restore(snap)
            self._metrics.inc(tnames.ONLINE_ROLLBACKS)
            self._journal(tnames.ONLINE_ROLLBACK_EVENT, version=version)
        self.machine.on_rollout_result(promoted)
        return {"state": self.machine.state, "action": "refit",
                "outcome": "promoted" if promoted else "rolled-back",
                "version": version}

    def run(self, max_cycles: int = 1,
            stop: Optional[Callable[[], bool]] = None) -> dict:
        """Poll until `max_cycles` full cycles completed (or `stop()`).
        Returns the last `run_once` status."""
        status = {"state": self.machine.state, "action": None}
        done = 0
        while done < max_cycles and (stop is None or not stop()):
            status = self.run_once()
            if status.get("outcome") is not None:
                done += 1
            else:
                self._sleep(self.config.poll_interval_s)
        return status

    def status(self) -> dict:
        return {"state": self.machine.state,
                "last_outcome": self.machine.last_outcome,
                "cycles": self.cycles,
                "feed": self.feed.stats(),
                "learner": {"updates": self.learner.updates,
                            "examples": self.learner.examples,
                            "refits": self.learner.refits}}
