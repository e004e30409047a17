"""Core contracts of the port (`mmlspark_tpu/core`): params, Table,
pipeline stages and their persistence."""
from .params import (HasFeaturesCol, HasInputCol, HasInputCols, HasLabelCol,
                     HasOutputCol, HasPredictionCol, HasProbabilitiesCol,
                     HasScoredLabelsCol, HasScoresCol, HasSeed, HasWeightCol,
                     Param, Params, in_range, one_of, positive)
from .pipeline import (STAGE_REGISTRY, Estimator, Evaluator, Model, Pipeline,
                       PipelineModel, PipelineStage, Transformer, ml_fit,
                       ml_transform)
from .table import Table

__all__ = [
    "Param", "Params", "Table", "PipelineStage", "Transformer", "Model",
    "Estimator", "Evaluator", "Pipeline", "PipelineModel", "ml_transform",
    "ml_fit", "STAGE_REGISTRY", "HasInputCol", "HasOutputCol", "HasInputCols",
    "HasLabelCol", "HasFeaturesCol", "HasWeightCol", "HasPredictionCol",
    "HasScoredLabelsCol", "HasScoresCol", "HasProbabilitiesCol", "HasSeed",
    "in_range", "one_of", "positive",
]
