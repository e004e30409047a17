"""LightGBM-equivalent GBDT on PyTorch/CUDA (port of
`mmlspark_tpu/models/gbdt`)."""
from .boosting import BoostParams, Callbacks, fit_booster
from .booster import Booster
from .distributed import fit_booster_distributed, make_sharded_tree_fn
from .estimators import (GBDTClassificationModel, GBDTClassifier,
                         GBDTRanker, GBDTRankerModel, GBDTRegressionModel,
                         GBDTRegressor, load_native_model)

__all__ = ["BoostParams", "Callbacks", "fit_booster", "Booster",
           "fit_booster_distributed", "make_sharded_tree_fn",
           "GBDTClassifier", "GBDTClassificationModel", "GBDTRegressor",
           "GBDTRegressionModel", "GBDTRanker", "GBDTRankerModel",
           "load_native_model"]
