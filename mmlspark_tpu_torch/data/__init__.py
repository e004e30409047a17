"""Parallel host ingest: the Spark-partitions analog (port of the
reference's `mmlspark_tpu/data/`).

`ChunkSource` splits a Table/array/file into ordered row-range chunks,
`WorkerPool` maps per-chunk transforms (binning, featurize) over processes
with shared-memory buffers or threads, `DevicePrefetcher` double-buffers
the host->device copy on its own CUDA stream so ingest overlaps device
compute instead of preceding it, `ChunkStager` stages binning out of core
under a residency budget with a durable resume cursor, and `ChunkPlanner`
assigns chunks to hosts.
"""
from .chunk import Chunk, ChunkSource, default_chunk_rows, make_chunks
from .pool import WorkerCrashError, WorkerPool
from .prefetch import DevicePrefetcher, prefetch_to_device
from .pipeline import (IngestOptions, IngestPipeline, ParallelTransform,
                       parallel_apply_bins, profile_columns, stage_binned)
from .oocore import ChunkStager, OocoreOptions
from .planner import ChunkPlanner

__all__ = [
    "Chunk", "ChunkSource", "default_chunk_rows", "make_chunks",
    "WorkerPool", "WorkerCrashError",
    "DevicePrefetcher", "prefetch_to_device",
    "IngestOptions", "IngestPipeline", "ParallelTransform",
    "parallel_apply_bins", "profile_columns", "stage_binned",
    "ChunkStager", "OocoreOptions", "ChunkPlanner",
]
