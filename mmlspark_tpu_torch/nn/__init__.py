"""Nearest-neighbor search of the port (`mmlspark_tpu/nn`): exact
inner-product top-k on the card."""
from .knn import KNN, KNNModel, ConditionalKNN, ConditionalKNNModel

__all__ = ["KNN", "KNNModel", "ConditionalKNN", "ConditionalKNNModel"]
