"""Host evaluation metrics of the port (`train/metrics.py`): the mergeable
states the streaming quality evaluator folds. The rest of the
reference's `train/` is ROADMAP Queue 1 item 27."""
from .metrics import (ConfusionState, RegressionState, binary_metrics,
                      multiclass_metrics, regression_metrics)

__all__ = ["ConfusionState", "RegressionState", "binary_metrics",
           "multiclass_metrics", "regression_metrics"]
