"""Meshes and sequence-parallel attention (port of `mmlspark_tpu/parallel`:
`mesh.py`'s axes and constructors, `ring_attention.py`)."""
from .mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Mesh,
                   data_mesh, grid_mesh)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "SEQ_AXIS", "Mesh",
           "data_mesh", "grid_mesh"]
