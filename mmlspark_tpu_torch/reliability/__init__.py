"""Checkpoint reliability of the port: the recovery-counter registry, the
seeded fault injector and the background checkpoint writer (ports of the
reference's `reliability` modules, which import no JAX)."""
from .faults import FaultInjector, InjectedCrash, InjectedFault
from .metrics import MetricsRegistry, reliability_metrics
from .supervisor import AsyncCheckpointWriter

__all__ = ["AsyncCheckpointWriter", "FaultInjector", "InjectedCrash",
           "InjectedFault", "MetricsRegistry", "reliability_metrics"]
