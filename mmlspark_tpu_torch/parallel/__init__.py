"""Meshes, multi-process clusters and sequence-parallel attention (port
of `mmlspark_tpu/parallel`: `mesh.py`'s axes, constructors and row
helpers, `cluster.py`, `ring_attention.py`)."""
from . import cluster
from .cluster import (ClusterInfo, Heartbeat, barrier, broadcast_from_leader,
                      global_array, initialize_cluster, padded_process_rows,
                      process_row_range)
from .mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Mesh,
                   NamedSharding, data_mesh, device_count, full_mesh,
                   grid_mesh, pad_to_multiple, replicated, row_sharding,
                   shard_rows, valid_row_mask)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "PIPE_AXIS", "SEQ_AXIS", "ClusterInfo",
           "Heartbeat", "Mesh", "NamedSharding", "barrier",
           "broadcast_from_leader", "cluster", "data_mesh", "device_count",
           "full_mesh", "global_array", "grid_mesh", "initialize_cluster",
           "pad_to_multiple", "padded_process_rows", "process_row_range",
           "replicated", "row_sharding", "shard_rows", "valid_row_mask"]
