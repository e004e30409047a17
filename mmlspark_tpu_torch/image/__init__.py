"""Image pipeline stages of the port (reference: `mmlspark_tpu/image`)."""
from .ops import (ImageSetAugmenter, ImageTransformer, ResizeImageTransformer,
                  UnrollImage, read_image_dir)

__all__ = ["ImageSetAugmenter", "ImageTransformer", "ResizeImageTransformer",
           "UnrollImage", "read_image_dir"]
