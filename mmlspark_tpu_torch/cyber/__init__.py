"""CyberML (reference: mmlspark/cyber — SURVEY.md §2.8): the port of the
reference's `cyber/` package. `AccessAnomaly` fits and scores on the
model's device (None = the card); the indexers, scalers, `DataFactory`
and `ComplementAccessTransformer` are host numpy, equal to the
reference's bit for bit."""
from .dataset import DataFactory
from .access_anomaly import (AccessAnomaly, AccessAnomalyModel,
                             ComplementAccessTransformer,
                             access_anomaly_from_reference)
from .features import (IdIndexer, IdIndexerModel, LinearScalarScaler,
                       LinearScalarScalerModel, StandardScalarScaler,
                       StandardScalarScalerModel)

__all__ = ["AccessAnomaly", "AccessAnomalyModel", "DataFactory",
           "ComplementAccessTransformer", "IdIndexer", "IdIndexerModel",
           "LinearScalarScaler", "LinearScalarScalerModel",
           "StandardScalarScaler", "StandardScalarScalerModel"]
