"""Deep-net models of the port: the transformer encoder and causal LM
training on one device."""
from .lm_training import ShardedLMTrainer
from .pp_training import PipelinedLMTrainer
from .transformer import (TransformerSentenceEncoder, init_transformer,
                          params_from_numpy, params_to_numpy,
                          transformer_apply)

__all__ = ["PipelinedLMTrainer", "ShardedLMTrainer",
           "TransformerSentenceEncoder", "init_transformer",
           "params_from_numpy", "params_to_numpy", "transformer_apply"]
