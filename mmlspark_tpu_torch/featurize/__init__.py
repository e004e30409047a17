"""Featurizers of the port: a copy of `mmlspark_tpu/featurize/` (host
numpy; their outputs equal the reference's bit for bit, the sparse
pairs' `logical_width` metadata included). `TextFeaturizer`'s dense
output densifies on its `device` (`ops.sparse.to_dense`)."""
from .value_indexer import ValueIndexer, ValueIndexerModel, IndexToValue
from .clean_missing import CleanMissingData, CleanMissingDataModel
from .featurize import (Featurize, FeaturizeModel, CountSelector,
                        CountSelectorModel, DataConversion)
from .text import TextFeaturizer, TextFeaturizerModel

__all__ = ["ValueIndexer", "ValueIndexerModel", "IndexToValue",
           "CleanMissingData", "CleanMissingDataModel", "Featurize",
           "FeaturizeModel", "CountSelector", "CountSelectorModel",
           "DataConversion", "TextFeaturizer", "TextFeaturizerModel"]
