"""Vowpal-Wabbit-equivalent hashed online learning on the card (port of
`mmlspark_tpu/models/vw`; reference: vw/ — SURVEY.md §2.4)."""
from .estimators import (VowpalWabbitClassificationModel,
                         VowpalWabbitClassifier,
                         VowpalWabbitContextualBandit,
                         VowpalWabbitContextualBanditModel,
                         VowpalWabbitRegressionModel, VowpalWabbitRegressor,
                         vw_from_reference)
from .featurizer import VowpalWabbitFeaturizer, VowpalWabbitInteractions

__all__ = ["VowpalWabbitFeaturizer", "VowpalWabbitInteractions",
           "VowpalWabbitClassifier", "VowpalWabbitRegressor",
           "VowpalWabbitContextualBandit", "VowpalWabbitClassificationModel",
           "VowpalWabbitRegressionModel", "VowpalWabbitContextualBanditModel",
           "vw_from_reference"]
