"""LightGBM-equivalent GBDT on PyTorch/CUDA (port of
`mmlspark_tpu/models/gbdt`)."""
from .boosting import BoostParams, fit_booster
from .booster import Booster
from .estimators import (GBDTClassificationModel, GBDTClassifier,
                         GBDTRegressionModel, GBDTRegressor)

__all__ = ["BoostParams", "fit_booster", "Booster", "GBDTClassifier",
           "GBDTClassificationModel", "GBDTRegressor", "GBDTRegressionModel"]
