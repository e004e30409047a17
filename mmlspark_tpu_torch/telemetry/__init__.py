"""Training telemetry of the port: the goodput clock
(`goodput.StepClock`). The reference's spans, SLOs, exposition and
profiles are ROADMAP Queue 1 item 23; its straggler detector is item
15(f)."""
from .goodput import PHASES, StepClock, peak_flops_from_env

__all__ = ["PHASES", "StepClock", "peak_flops_from_env"]
