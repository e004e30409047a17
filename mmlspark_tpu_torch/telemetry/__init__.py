"""Training telemetry of the port: the goodput clock
(`goodput.StepClock`), the straggler detector (`goodput.StragglerDetector`)
and the fit-time quality profile (`quality`). The reference's spans, SLOs,
exposition, profiles and serving-side quality taps are ROADMAP Queue 1
item 23."""
from .goodput import PHASES, StepClock, StragglerDetector, peak_flops_from_env

__all__ = ["PHASES", "StepClock", "StragglerDetector", "peak_flops_from_env"]
