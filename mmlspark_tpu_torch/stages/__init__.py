"""Host pipeline stages of the port: the mini-batching transformers and
the serving buckets (`stages/batching.py`). The reference's other
`stages/` modules are ROADMAP Queue 1 item 27."""
from .batching import (DynamicMiniBatchTransformer, FixedMiniBatchTransformer,
                       FlattenBatch, TimeIntervalMiniBatchTransformer,
                       pad_rows_to_bucket, shape_bucket)

__all__ = ["DynamicMiniBatchTransformer", "FixedMiniBatchTransformer",
           "FlattenBatch", "TimeIntervalMiniBatchTransformer",
           "pad_rows_to_bucket", "shape_bucket"]
