"""Core contracts of the port (trimmed copies of `mmlspark_tpu/core`)."""
from .params import (HasFeaturesCol, HasInputCol, HasLabelCol, HasOutputCol,
                     HasPredictionCol, HasProbabilitiesCol, HasWeightCol,
                     Param, Params, in_range, one_of)
from .pipeline import Estimator, Model, Transformer
from .table import Table

__all__ = [
    "Param", "Params", "Table", "Transformer", "Model", "Estimator",
    "HasLabelCol", "HasFeaturesCol", "HasWeightCol", "HasPredictionCol",
    "HasProbabilitiesCol", "HasInputCol", "HasOutputCol", "in_range",
    "one_of",
]
