"""Meshes and sequence-parallel attention (port of `mmlspark_tpu/parallel`:
`mesh.py`'s axes, constructors and row helpers, `ring_attention.py`)."""
from .mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Mesh,
                   NamedSharding, data_mesh, full_mesh, grid_mesh,
                   pad_to_multiple, replicated, row_sharding, shard_rows,
                   valid_row_mask)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "SEQ_AXIS", "Mesh",
           "NamedSharding", "data_mesh", "full_mesh", "grid_mesh",
           "pad_to_multiple", "replicated", "row_sharding", "shard_rows",
           "valid_row_mask"]
