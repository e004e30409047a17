"""LIME interpretability of the port (`mmlspark_tpu/lime/`): tabular,
image and text explainers with the batched local lasso on the card."""
from .lasso import batched_lasso
from .lime import ImageLIME, TabularLIME, TabularLIMEModel, TextLIME
from .superpixel import SuperpixelTransformer, mask_image, slic_superpixels

__all__ = ["ImageLIME", "TabularLIME", "TabularLIMEModel", "TextLIME",
           "SuperpixelTransformer", "batched_lasso", "mask_image",
           "slic_superpixels"]
