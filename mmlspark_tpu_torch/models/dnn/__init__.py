"""Deep-net models of the port (so far the transformer encoder)."""
from .transformer import (TransformerSentenceEncoder, init_transformer,
                          params_from_numpy, transformer_apply)

__all__ = ["TransformerSentenceEncoder", "init_transformer",
           "params_from_numpy", "transformer_apply"]
