"""Training reliability of the port: the recovery-counter registry, the
seeded fault injector, retry policies, the background checkpoint writer
and the training supervisor (ports of the reference's `reliability`
modules, which import no JAX)."""
from .faults import FaultInjector, InjectedCrash, InjectedFault
from .metrics import MetricsRegistry, reliability_metrics
from .policy import Deadline, RetryBudget, RetryPolicy
from .supervisor import (AsyncCheckpointWriter, Preempted, StepTimeout,
                         TrainingSupervisor)

__all__ = ["AsyncCheckpointWriter", "Deadline", "FaultInjector",
           "InjectedCrash", "InjectedFault", "MetricsRegistry", "Preempted",
           "RetryBudget", "RetryPolicy", "StepTimeout", "TrainingSupervisor",
           "reliability_metrics"]
