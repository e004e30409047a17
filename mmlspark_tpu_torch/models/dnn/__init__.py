"""Deep-net models of the port: the image path (DNNModel, the ResNet zoo,
ImageFeaturizer, the ONNX importer, transfer learning), the transformer
encoder and causal LM training, on one device or over a mesh."""
from .image_featurizer import ImageFeaturizer
from .lm_training import ShardedLMTrainer
from .model import DNNModel
from .onnx_import import load_onnx
from .pp_training import PipelinedLMTrainer
from .resnet import ResNet, resnet18, resnet50
from .transfer import DeepTransferClassifier, DeepTransferModel
from .transformer import (TransformerSentenceEncoder, init_transformer,
                          params_from_numpy, params_to_numpy,
                          transformer_apply)

__all__ = ["DNNModel", "ResNet", "resnet18", "resnet50", "ImageFeaturizer",
           "DeepTransferClassifier", "DeepTransferModel", "load_onnx",
           "PipelinedLMTrainer", "ShardedLMTrainer",
           "TransformerSentenceEncoder", "init_transformer",
           "params_from_numpy", "params_to_numpy", "transformer_apply"]
