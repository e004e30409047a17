"""Fleet workloads of the port (`mmlspark_tpu/workloads`): anomaly
detection and recommendation on the serving / training / observability
stack. Each workload costs an estimator and a plan builder; serving's
fast path, supervisor checkpoints, lineage versions, drift references and
hot-swap are inherited.
"""
from .base import attach_workload_observability
from .iforest import IsolationForestScorer, IsolationForestScorerModel
from .sar_serving import SARServing, SARServingModel

__all__ = [
    "attach_workload_observability",
    "IsolationForestScorer", "IsolationForestScorerModel",
    "SARServing", "SARServingModel",
]
