"""Serving control plane: the ACTUATION tier over serving, registry and
telemetry (port of the reference's `control/`).

- `rollout`: progressive delivery. `RolloutDriver` installs a candidate
  model on staged traffic fractions, watches the fleet's canary/SLO
  verdicts through a deterministic state machine, and auto-promotes or
  auto-rolls-back (idempotent, retry-bounded), every transition
  journaled to the RunLedger and emitted as a `control.rollout.*` event.
- `actuators`: `WeightedRouter` (target selection weighted by scraped
  queue depth and windowed p99), `BurnAwareAdmission` (shed-before-queue
  with Retry-After while the error budget burns) and `FleetScaler`
  (occupancy-driven drain/spawn hooks).

Everything here is host-side control logic, plain Python over the
telemetry and serving substrates: no module of this package imports
torch itself (the substrates it drives hold the card's work).
"""
from .actuators import BurnAwareAdmission, FleetScaler, WeightedRouter
from .rollout import (Action, Observation, RolloutConfig, RolloutDriver,
                      RolloutStateMachine)

__all__ = [
    "Action",
    "BurnAwareAdmission",
    "FleetScaler",
    "Observation",
    "RolloutConfig",
    "RolloutDriver",
    "RolloutStateMachine",
    "WeightedRouter",
]
