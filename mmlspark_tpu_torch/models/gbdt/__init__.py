"""LightGBM-equivalent GBDT on PyTorch/CUDA (port of
`mmlspark_tpu/models/gbdt`)."""
from .boosting import BoostParams, Callbacks, fit_booster
from .booster import Booster
from .distributed import fit_booster_distributed, make_sharded_tree_fn
from .estimators import (GBDTClassificationModel, GBDTClassifier,
                         GBDTRanker, GBDTRankerModel, GBDTRegressionModel,
                         GBDTRegressor, load_native_model)
from .trainer import Tree, TreeConfig, train_one_tree

# the reference's aliases for users of MMLSpark's names
LightGBMClassifier = GBDTClassifier
LightGBMClassificationModel = GBDTClassificationModel
LightGBMRegressor = GBDTRegressor
LightGBMRegressionModel = GBDTRegressionModel
LightGBMRanker = GBDTRanker
LightGBMRankerModel = GBDTRankerModel

__all__ = ["BoostParams", "Callbacks", "fit_booster", "Booster",
           "fit_booster_distributed", "make_sharded_tree_fn", "Tree",
           "TreeConfig", "train_one_tree", "GBDTClassifier",
           "GBDTClassificationModel", "GBDTRegressor", "GBDTRegressionModel",
           "GBDTRanker", "GBDTRankerModel", "load_native_model",
           "LightGBMClassifier", "LightGBMClassificationModel",
           "LightGBMRegressor", "LightGBMRegressionModel", "LightGBMRanker",
           "LightGBMRankerModel"]
