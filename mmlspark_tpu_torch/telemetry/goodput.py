"""Training-loop goodput/MFU accounting.

Port of `StepClock` and `peak_flops_from_env` from the reference's
`telemetry/goodput.py:98-368` (which imports no JAX). Driven by
`reliability.supervisor.TrainingSupervisor` and
`ShardedLMTrainer.run_stream`, it decomposes every step's wall time into
phases —

  * `data_wait`   — consumer blocked on an empty `data.DevicePrefetcher`
                    queue (the overlap failed to hide the producer),
  * `device`      — time inside an explicit sync boundary
                    (`device_block`, e.g. `float(loss)`),
  * `checkpoint`  — snapshot + submit stall on the step thread,
  * `lost`        — restart/replay rewinds, failed step attempts and
                    injected stalls (time that produced no state),
  * `host`        — the remainder of the step wall —

rolled into goodput = 1 - (data_wait + checkpoint + lost) / wall and, when
a per-step flops figure and a peak are known, a model-flops-utilization
gauge. The accounting state rides the supervisor's checkpoint payload
(`state_vector`, the reference's layout), so a killed-and-resumed run
keeps its cumulative goodput, in either package.

`StragglerDetector` (the reference's `:370-458`): processes exchange
their windowed step p50s through the `parallel.cluster.Heartbeat` files
(`beat(epoch, stats=clock.beat_stats())`); each reads every peer's file
on its own beat, takes the fleet median, and flags processes whose p50
exceeds `threshold` x the median, with the `train.stragglers` gauge and
a `train.straggler` event on the flag transition (to the given `tracer`,
else the process tracer). A process newly flagged itself captures one
device profile (`profile_on_flag`, `telemetry.profiler`; rate-limited by
the session's own slot, a no-op until a profile dir is configured).

A clock installs itself as the process default (`install_clock`):
`default_snapshot()` is what a flight bundle's goodput.json holds.
`flops_from_compile_log` reads a step's flops from the newest compile
record that reported them (`telemetry.perf`'s first-call analysis).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Optional

from ..reliability import names as tnames
from ..reliability.metrics import reliability_metrics
from .spans import get_tracer

PHASES = ("data_wait", "host", "device", "checkpoint", "lost")

# Optional peak-flops anchor for the MFU gauge (TFLOP/s of the card, e.g.
# 989 for the H100's dense bf16 tensor cores). Unset -> MFU degrades to
# absent, never a guessed denominator.
PEAK_TFLOPS_ENV = "MMLSPARK_TPU_PEAK_TFLOPS"


def flops_from_compile_log(fingerprint_prefix: str, log=None
                           ) -> Optional[float]:
    """Per-step flops from the newest compile record whose fingerprint
    starts with `fingerprint_prefix` and carries a `flops` analysis; None
    when no matching record reported flops (MFU is then absent)."""
    from .perf import get_compile_log
    records = (log if log is not None else get_compile_log()).records()
    for rec in reversed(records):
        if not str(rec.get("fingerprint", "")).startswith(fingerprint_prefix):
            continue
        flops = (rec.get("analysis") or {}).get("flops")
        if isinstance(flops, (int, float)) and flops > 0:
            return float(flops)
    return None


def peak_flops_from_env() -> Optional[float]:
    """Peak FLOP/s from ``MMLSPARK_TPU_PEAK_TFLOPS`` (TFLOP/s), or None."""
    raw = os.environ.get(PEAK_TFLOPS_ENV)
    if not raw:
        return None
    try:
        tflops = float(raw)
    except ValueError:
        return None
    return tflops * 1e12 if tflops > 0 else None


class StepClock:
    """Phase-decomposed training-step accounting (module docstring).

    Thread contract: one step is active at a time (the training loop's);
    `note()` may arrive from other threads and is attributed to the active
    step when one is open, to the run otherwise. All state sits behind one
    lock with tiny critical sections.
    """

    # state_vector layout (rides the supervisor checkpoint payload as a
    # float64 array; append-only so older checkpoints keep restoring)
    _STATE_FIELDS = ("wall_s", "lost_s", "data_wait_s", "checkpoint_s",
                     "device_s", "steps", "since_mark_s")

    def __init__(self, registry=None, flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 recent_steps: int = 64, install: bool = True):
        self._metrics = registry if registry is not None \
            else reliability_metrics
        self.flops_per_step = flops_per_step
        self.peak_flops = (peak_flops if peak_flops is not None
                           else peak_flops_from_env())
        self._lock = threading.Lock()
        self._wall_s = 0.0          # every accounted second lands here
        self._lost_s = 0.0
        self._data_wait_s = 0.0
        self._checkpoint_s = 0.0
        self._device_s = 0.0
        self._steps = 0             # completed step attempts
        self._since_mark_s = 0.0    # productive wall since the last mark
        self._in_step = False
        self._step_notes: dict = {}
        self._recent: deque = deque(maxlen=max(int(recent_steps), 4))
        if install:
            install_clock(self)

    # -- collaborator notes ---------------------------------------------------
    def note(self, phase: str, seconds: float) -> None:
        """Attribute `seconds` to a phase. Inside a step the time is part
        of the step's wall (the step context measured it already);
        outside it extends the run wall too."""
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}; one of {PHASES}")
        s = max(float(seconds), 0.0)
        with self._lock:
            if self._in_step:
                self._step_notes[phase] = self._step_notes.get(phase, 0.0) + s
                return
            self._wall_s += s
            self._add_phase(phase, s)
        self._publish(step_wall_s=None)

    def _add_phase(self, phase: str, s: float) -> None:
        # lock held by caller
        if phase == "data_wait":
            self._data_wait_s += s
        elif phase == "checkpoint":
            self._checkpoint_s += s
        elif phase == "device":
            self._device_s += s
        elif phase == "lost":
            self._lost_s += s
        # "host" is the derived remainder; an explicit host note is wall-only

    # -- the step boundary ----------------------------------------------------
    @contextmanager
    def step(self, step: Optional[int] = None):
        """Measure one step attempt. A clean exit books the wall as
        productive (minus in-step notes, which keep their phases); an
        exception books the WHOLE attempt as lost."""
        with self._lock:
            self._in_step = True
            self._step_notes = {}
        t0 = time.perf_counter()
        try:
            yield self
        except BaseException:
            dt = time.perf_counter() - t0
            with self._lock:
                self._in_step = False
                self._wall_s += dt
                self._lost_s += dt
            self._publish(step_wall_s=None)
            raise
        dt = time.perf_counter() - t0
        with self._lock:
            self._in_step = False
            notes = self._step_notes
            self._step_notes = {}
            self._wall_s += dt
            self._steps += 1
            noted = 0.0
            for phase, s in notes.items():
                s = min(s, dt - noted)       # notes can't exceed the wall
                self._add_phase(phase, s)
                noted += s
            self._since_mark_s += self._rewindable(dt, notes)
            self._recent.append(dt * 1000.0)
        self._publish(step_wall_s=dt, notes=notes)

    @staticmethod
    def _rewindable(wall_s: float, notes: dict) -> float:
        """The part of a step's wall a later rewind may move to lost."""
        bad = sum(notes.get(p, 0.0)
                  for p in ("lost", "data_wait", "checkpoint"))
        return max(wall_s - bad, 0.0)

    def device_block(self, fn: Callable):
        """Run `fn` (a sync boundary: `float(loss)`) and book its time as
        device compute."""
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            self.note("device", time.perf_counter() - t0)

    # -- rewind/mark bookkeeping (supervisor hooks) ---------------------------
    def marked(self) -> None:
        """A durable snapshot was taken: work before this point can no
        longer be lost to an in-process rewind."""
        with self._lock:
            self._since_mark_s = 0.0

    def rewound(self) -> None:
        """The loop restarted from the last snapshot: everything since
        that mark will be re-executed, so its wall moves to lost."""
        with self._lock:
            self._lost_s += self._since_mark_s
            self._since_mark_s = 0.0
        self._publish(step_wall_s=None)

    # -- checkpoint ride-along ------------------------------------------------
    def state_vector(self) -> list:
        """Accounting state as a flat float list (the supervisor stores it
        as a float64 array in the checkpoint payload)."""
        with self._lock:
            # since_mark exports as 0: a restored run stands exactly AT
            # its mark, with nothing rewindable behind it
            return [self._wall_s, self._lost_s, self._data_wait_s,
                    self._checkpoint_s, self._device_s, float(self._steps),
                    0.0]

    def restore_state(self, vec) -> None:
        """Adopt a prior run's accounting (resume path)."""
        vals = [float(v) for v in vec]
        vals += [0.0] * (len(self._STATE_FIELDS) - len(vals))
        with self._lock:
            (self._wall_s, self._lost_s, self._data_wait_s,
             self._checkpoint_s, self._device_s, steps,
             self._since_mark_s) = vals[:7]
            self._steps = int(steps)
        self._publish(step_wall_s=None)

    def publish(self) -> None:
        """Refresh the goodput/MFU/lost gauges now."""
        self._publish(step_wall_s=None)

    # -- read side ------------------------------------------------------------
    def goodput(self) -> float:
        with self._lock:
            return self._goodput_locked()

    def _goodput_locked(self) -> float:
        if self._wall_s <= 0.0:
            return 1.0
        bad = self._lost_s + self._data_wait_s + self._checkpoint_s
        return max(1.0 - bad / self._wall_s, 0.0)

    def mfu(self) -> Optional[float]:
        """flops_per_step * steps / (wall * peak_flops); None when either
        flops side is unknown."""
        with self._lock:
            wall, steps = self._wall_s, self._steps
        if (self.flops_per_step is None or self.peak_flops is None
                or wall <= 0.0 or self.peak_flops <= 0.0):
            return None
        return self.flops_per_step * steps / (wall * self.peak_flops)

    def step_p50_ms(self) -> float:
        """Windowed (recent-steps) step-wall median."""
        with self._lock:
            recent = sorted(self._recent)
        return recent[len(recent) // 2] if recent else 0.0

    def beat_stats(self) -> dict:
        """The per-process stats a `Heartbeat.beat` carries to peers."""
        with self._lock:
            steps = self._steps
            goodput = self._goodput_locked()
        return {"step_p50_ms": round(self.step_p50_ms(), 3),
                "steps": steps, "goodput": round(goodput, 4)}

    def snapshot(self) -> dict:
        """The step-phase breakdown."""
        with self._lock:
            wall = self._wall_s
            phases = {"data_wait_s": self._data_wait_s,
                      "device_s": self._device_s,
                      "checkpoint_s": self._checkpoint_s,
                      "lost_s": self._lost_s}
            phases["host_s"] = max(wall - sum(phases.values()), 0.0)
            steps = self._steps
            goodput = self._goodput_locked()
        return {"steps": steps, "wall_s": wall, "goodput": goodput,
                "mfu": self.mfu(), "step_p50_ms": self.step_p50_ms(),
                "phases": phases}

    # -- metric publication ---------------------------------------------------
    def _publish(self, step_wall_s: Optional[float],
                 notes: Optional[dict] = None) -> None:
        """Gauges on every accounting change; histograms per completed
        step. Never under the clock lock (the registry has its own)."""
        m = self._metrics
        m.set_gauge(tnames.TRAIN_GOODPUT, round(self.goodput(), 6))
        with self._lock:
            lost = self._lost_s
        m.set_gauge(tnames.TRAIN_LOST_SECONDS, round(lost, 6))
        mfu = self.mfu()
        if mfu is not None:
            m.set_gauge(tnames.TRAIN_MFU, round(mfu, 6))
        if step_wall_s is None:
            return
        m.observe_ms(tnames.TRAIN_STEP_WALL, step_wall_s * 1000.0)
        noted = 0.0
        for phase, s in (notes or {}).items():
            noted += s
            if s > 0.0:
                m.observe_ms(tnames.train_step_phase(phase), s * 1000.0)
        host_s = max(step_wall_s - noted, 0.0)
        if host_s > 0.0:
            m.observe_ms(tnames.train_step_phase("host"), host_s * 1000.0)


class StragglerDetector:
    """Flag processes whose windowed step p50 exceeds `threshold` x the
    fleet median, from heartbeat-exchanged stats (module docstring).
    Driven by the supervisor on each of its own beats; every process runs
    the same check over the same files, so they agree. Rows older than
    `max_age_s` leave the check (a dead host's frozen stats are
    `reliability.elastic.HostLeases`' business); None keeps them."""

    def __init__(self, heartbeat, threshold: float = 1.5,
                 min_steps: int = 4, registry=None, tracer=None,
                 profile_on_flag: bool = True,
                 max_age_s: Optional[float] = 30.0):
        self.heartbeat = heartbeat
        self.threshold = float(threshold)
        self.min_steps = max(int(min_steps), 1)
        self.max_age_s = max_age_s
        self._metrics = registry if registry is not None \
            else reliability_metrics
        self._tracer = tracer
        # THIS process newly flagged -> one triggered device-profile
        # capture of the very steps that straggle (rate-limited by the
        # session's own slot; absorbed)
        self.profile_on_flag = bool(profile_on_flag)
        self._flagged: set = set()

    def check(self) -> list:
        """One detection pass; returns the straggler rows (process_id,
        step_p50_ms, fleet_p50_ms, threshold). Never raises: detection is
        observability."""
        try:
            rows = self.heartbeat.read_all(max_age_s=self.max_age_s)
        except Exception:  # noqa: BLE001 - a torn beat loses one pass
            return []
        p50s = []
        for row in rows:
            stats = row.get("stats") or {}
            p50 = stats.get("step_p50_ms")
            if (isinstance(p50, (int, float)) and p50 > 0.0
                    and stats.get("steps", 0) >= self.min_steps):
                p50s.append((int(row.get("process_id", -1)), float(p50)))
        if len(p50s) < 2:       # a fleet of one has no stragglers
            self._metrics.set_gauge(tnames.TRAIN_STRAGGLERS, 0)
            return []
        ordered = sorted(v for _, v in p50s)
        half = len(ordered) // 2
        median = ordered[half] if len(ordered) % 2 else \
            0.5 * (ordered[half - 1] + ordered[half])
        stragglers = [
            {"process_id": pid, "step_p50_ms": p50,
             "fleet_p50_ms": median, "threshold": self.threshold}
            for pid, p50 in p50s
            if median > 0.0 and p50 > self.threshold * median]
        now_flagged = {s["process_id"] for s in stragglers}
        tracer = self._tracer if self._tracer is not None else get_tracer()
        for s in stragglers:
            if s["process_id"] not in self._flagged:
                tracer.event(tnames.TRAIN_STRAGGLER_EVENT,
                             host=s["process_id"],
                             step_p50_ms=round(s["step_p50_ms"], 3),
                             fleet_p50_ms=round(s["fleet_p50_ms"], 3),
                             threshold=self.threshold)
        own = getattr(self.heartbeat, "process_id", None)
        capture_self = (self.profile_on_flag and own is not None
                        and own in now_flagged and own not in self._flagged)
        self._flagged = now_flagged
        self._metrics.set_gauge(tnames.TRAIN_STRAGGLERS, len(now_flagged))
        if capture_self:
            # after the train.straggler event: the capture's
            # telemetry.profile event follows it in the span log
            try:
                from .profiler import get_profile_session
                get_profile_session().capture(reason="straggler")
            except Exception:  # noqa: BLE001 - detection must not raise
                pass
        return stragglers


# The process-default clock: what the flight recorder's goodput.json reads
# when nobody handed it a clock. Last installed wins.
_default_clock: Optional[StepClock] = None
_default_lock = threading.Lock()


def install_clock(clock: StepClock) -> StepClock:
    global _default_clock
    with _default_lock:
        _default_clock = clock
    return clock


def get_clock() -> Optional[StepClock]:
    with _default_lock:
        return _default_clock


def default_snapshot() -> dict:
    """The installed clock's snapshot, or {}: safe from any context (the
    flight recorder calls this mid-dump)."""
    clock = get_clock()
    if clock is None:
        return {}
    try:
        return clock.snapshot()
    except Exception:  # noqa: BLE001 - a bundle without goodput beats none
        return {}
