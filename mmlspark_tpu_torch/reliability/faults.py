"""Deterministic, seedable fault injection.

Port of the reference's `reliability/faults.py` (which imports no JAX):
every injected failure (delays, errors, crashes, truncated files) comes
from one seeded schedule, so a test that fails prints a seed
that replays the identical fault sequence. The port's checkpoint writer
(`reliability.supervisor.AsyncCheckpointWriter`) fires the site
"train.ckpt.write" before each write.

- Injection *sites* are names; every `fire(site)` call increments a
  per-site counter, and rules match by site glob and fire at fixed
  per-site call indices (`"at": [2, 5]`) or with a seeded per-site
  probability (`"prob": 0.1`).
- Per-site random streams are seeded from `crc32(site) ^ seed`, not
  Python's randomized `hash()`, so the schedule is stable across
  processes and independent of the order other sites are exercised.
- `history` records every fired fault as `(site, call_index, kind)`; two
  runs with the same seed and the same per-site calls have equal
  histories.
- Disabled, code holds `None` and pays nothing.

Activation: pass an injector to the code under test, e.g.
`AsyncCheckpointWriter(manager, faults=FaultInjector(seed=7, rules=[{"site":
"train.ckpt.write", "kind": "error", "at": [1]}]))`. The serving server
(`io.serving.ServingServer`), as the reference's, also reads
`MMLSPARK_TPU_FAULTS='{"seed": 7, "rules": [{"site": "serving.worker",
"kind": "crash", "at": [1]}]}'` through `FaultInjector.from_env()` when it
is given none. Each fired fault is also a `fault.injected` event on the
telemetry tracer.
"""
from __future__ import annotations

import fnmatch
import json
import os
import random
import threading
import time
import zlib
from typing import Callable, NamedTuple, Optional

FAULTS_ENV = "MMLSPARK_TPU_FAULTS"

# Hard cap on injected delays: fault tests must stay fast.
MAX_INJECTED_DELAY = 0.2


class InjectedFault(Exception):
    """A recoverable injected failure (retry/replay paths absorb it)."""


class InjectedCrash(InjectedFault):
    """An injected worker DEATH: escapes the worker's recovery catch so the
    thread actually dies and the watchdog/replay machinery must engage."""


class Fault(NamedTuple):
    site: str
    index: int          # per-site call index the fault fired at
    kind: str           # crash | error | delay | reset | corrupt | ...
    param: Optional[float] = None


class FaultInjector:
    """Seeded rule-driven fault source. See module docstring for the rule
    shapes; unknown kinds are returned to the caller to interpret (serving
    handles "reset", checkpoint tests handle "corrupt", ...)."""

    def __init__(self, seed: int = 0, rules: Optional[list] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.seed = int(seed)
        self.rules = list(rules or [])
        for r in self.rules:
            if "site" not in r or "kind" not in r:
                raise ValueError(f"fault rule needs site+kind: {r!r}")
        self._sleep = sleep
        self._lock = threading.Lock()
        self._counts: dict = {}
        self._rngs: dict = {}
        self.history: list = []   # list[Fault], in fire order

    @classmethod
    def from_env(cls, var: str = FAULTS_ENV) -> Optional["FaultInjector"]:
        """Build from the env var's JSON spec; None when unset (the
        zero-overhead disabled state)."""
        spec = os.environ.get(var)
        if not spec:
            return None
        cfg = json.loads(spec)
        return cls(seed=cfg.get("seed", 0), rules=cfg.get("rules", []))

    # -- deterministic per-site randomness ------------------------------------
    def _site_rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            # crc32, not hash(): stable across processes/PYTHONHASHSEED
            rng = random.Random(zlib.crc32(site.encode()) ^ self.seed)
            self._rngs[site] = rng
        return rng

    def _emit(self, fault: Fault) -> None:
        """A `fault.injected` event per fired fault, so a chaos run's event
        log interleaves injections with the recovery they provoked.
        Guarded: observability never changes a fault schedule."""
        try:
            from ..telemetry.names import FAULT_INJECTED_EVENT
            from ..telemetry.spans import get_tracer
            get_tracer().event(FAULT_INJECTED_EVENT, site=fault.site,
                               index=fault.index, kind=fault.kind)
        except Exception:  # noqa: BLE001
            pass

    # -- core ------------------------------------------------------------------
    def fire(self, site: str) -> Optional[Fault]:
        """Advance the site's call counter and return the fault scheduled
        for this call, if any. First matching rule wins."""
        fault = None
        with self._lock:
            index = self._counts.get(site, 0)
            self._counts[site] = index + 1
            for rule in self.rules:
                if not fnmatch.fnmatchcase(site, rule["site"]):
                    continue
                at = rule.get("at")
                if at is not None:
                    if index not in at:
                        continue
                elif self._site_rng(site).random() >= rule.get("prob", 0.0):
                    continue
                fault = Fault(site, index, rule["kind"], rule.get("param"))
                self.history.append(fault)
                break
        if fault is not None:
            self._emit(fault)
        return fault

    def perturb(self, site: str) -> Optional[Fault]:
        """fire() plus the generic kinds applied in place: "delay" sleeps
        (capped), "error" raises InjectedFault, "crash" raises
        InjectedCrash. Site-specific kinds are returned for the caller."""
        fault = self.fire(site)
        if fault is None:
            return None
        if fault.kind == "delay":
            self._sleep(min(fault.param or 0.05, MAX_INJECTED_DELAY))
            return fault
        if fault.kind == "crash":
            raise InjectedCrash(f"injected crash at {site}#{fault.index}")
        if fault.kind == "error":
            raise InjectedFault(f"injected error at {site}#{fault.index}")
        return fault

    # -- file corruption -------------------------------------------------------
    def corrupt_file(self, path: str, site: str = "checkpoint") -> None:
        """Truncate a file to a seeded fraction of its size — the
        checkpoint-corruption fault (a crash mid-write of a non-atomic
        copy, a torn disk)."""
        size = os.path.getsize(path)
        with self._lock:
            index = self._counts.get(site, 0)
            self._counts[site] = index + 1
            keep = self._site_rng(site).randrange(max(size, 1))
            self.history.append(Fault(site, index, "corrupt:truncate-file",
                                      float(keep)))
        with open(path, "rb+") as f:
            f.truncate(keep)

    # -- introspection ---------------------------------------------------------
    def schedule(self) -> list:
        """(site, index, kind) triples of every fired fault — compare across
        runs to assert seed-reproducibility."""
        return [(f.site, f.index, f.kind) for f in self.history]

    def __repr__(self):
        return (f"FaultInjector(seed={self.seed}, rules={len(self.rules)}, "
                f"fired={len(self.history)})")
