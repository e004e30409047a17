"""Training reliability of the port: the recovery-counter registry, the
seeded fault injector, retry policies, the background checkpoint writer,
the training supervisor and elastic multi-process training (ports of the
reference's `reliability` modules, which import no JAX)."""
from .elastic import ElasticPlan, FleetCheckpoint, HostLeases, leader
from .faults import FaultInjector, InjectedCrash, InjectedFault
from .metrics import MetricsRegistry, reliability_metrics
from .policy import (Attempt, CircuitBreaker, CircuitOpenError, Deadline,
                     RetryBudget, RetryPolicy)
from .supervisor import (AsyncCheckpointWriter, Preempted, StepTimeout,
                         TrainingSupervisor)

__all__ = ["AsyncCheckpointWriter", "Attempt", "CircuitBreaker",
           "CircuitOpenError", "Deadline", "ElasticPlan",
           "FaultInjector", "FleetCheckpoint", "HostLeases", "InjectedCrash",
           "InjectedFault", "MetricsRegistry", "Preempted", "RetryBudget",
           "RetryPolicy", "StepTimeout", "TrainingSupervisor", "leader",
           "reliability_metrics"]
