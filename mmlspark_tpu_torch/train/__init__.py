"""Training wrappers and evaluation of the port (`mmlspark_tpu/train/`):
`TrainClassifier`/`TrainRegressor` (auto-featurization around an inner
learner), `ComputeModelStatistics`, `ComputePerInstanceStatistics`, the
evaluators AutoML scores with, and the host metrics (`train/metrics.py`:
the mergeable states the streaming quality evaluator folds)."""
from . import metrics
from .compute_model_statistics import (ClassificationEvaluator,
                                       ComputeModelStatistics,
                                       ComputePerInstanceStatistics,
                                       RegressionEvaluator)
from .metrics import (ConfusionState, RegressionState, binary_metrics,
                      multiclass_metrics, regression_metrics)
from .train_classifier import (TrainClassifier, TrainedClassifierModel,
                               TrainedRegressorModel, TrainRegressor,
                               trained_from_reference)

__all__ = ["ComputeModelStatistics", "ComputePerInstanceStatistics",
           "ClassificationEvaluator", "RegressionEvaluator", "TrainClassifier",
           "TrainedClassifierModel", "TrainRegressor", "TrainedRegressorModel",
           "trained_from_reference", "metrics", "ConfusionState",
           "RegressionState", "binary_metrics", "multiclass_metrics",
           "regression_metrics"]
