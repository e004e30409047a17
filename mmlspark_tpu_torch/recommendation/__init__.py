"""Recommendation of the port (`mmlspark_tpu/recommendation`): SAR on
the card and the ranking stages and metrics around recommenders."""
from .ranking import (RankingAdapter, RankingAdapterModel, RankingEvaluator,
                      RankingTrainValidationSplit,
                      RankingTrainValidationSplitModel,
                      RecommendationIndexer, RecommendationIndexerModel,
                      ranking_metrics)
from .sar import SAR, SARModel

__all__ = ["SAR", "SARModel", "RankingAdapter", "RankingAdapterModel",
           "RankingEvaluator", "RankingTrainValidationSplit",
           "RankingTrainValidationSplitModel", "RecommendationIndexer",
           "RecommendationIndexerModel", "ranking_metrics"]
