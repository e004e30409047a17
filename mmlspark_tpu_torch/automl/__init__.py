"""AutoML of the port (`mmlspark_tpu/automl/`): hyperparameter spaces,
`TuneHyperparameters` and `FindBestModel`."""
from .hyperparam import (DiscreteHyperParam, RangeHyperParam, GridSpace,
                         RandomSpace, HyperparamBuilder)
from .tune_hyperparameters import TuneHyperparameters, TuneHyperparametersModel
from .find_best_model import FindBestModel, BestModel

__all__ = ["DiscreteHyperParam", "RangeHyperParam", "GridSpace", "RandomSpace",
           "HyperparamBuilder", "TuneHyperparameters",
           "TuneHyperparametersModel", "FindBestModel", "BestModel"]
