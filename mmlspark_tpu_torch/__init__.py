"""PyTorch/CUDA port of `mmlspark_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference; this package keeps its
layout and names so each module's counterpart is easy to find, and imports
neither `jax` nor anything of `mmlspark_tpu`. Ported so far: single-device
GBDT fit -> predict (binning, the histogram kernels, split search, row
routing, the boosting loop, `Booster` scoring and the GBDT estimators),
transformer encoder serving and causal LM training (`models.dnn`, with the
flash-attention kernels), and ring and Ulysses attention over a
single-controller mesh (`parallel`), which the trainer uses for its data
and seq axes.

Entry points run on the card unless the caller passes `device="cpu"`; with
no card they raise (see `device.resolve_device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
