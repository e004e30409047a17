"""Parallel host ingest pipeline: chunked transforms overlapped with the
device feed.

Port of the reference's `data/pipeline.py`: the composition of the three
data/ primitives —

    ChunkSource  ->  WorkerPool (bin / featurize per chunk)  ->
    DevicePrefetcher (copy chunk k+1 while chunk k lands on the card)

— the Spark-partitions analog for the port's single-host Tables. Chunk
transforms run on every core, and the device feed streams per chunk
instead of waiting for the whole matrix.

Determinism contract: for any row-independent transform, output is
bit-identical to the sequential path for every `num_workers`/`chunk_rows`/
backend combination — chunks are contiguous ordered row ranges and results
are written back by range, never by completion order.

`_bin_rows` bins with the host `ops.binning.apply_bins`. The reference
prefers its host C++ binner (`mmlspark_tpu/native/kernels.cpp`) and pins
its numpy path as bit-identical to it, so the bins are the same either
way; the native binner is ROADMAP Queue 1 item 28. `profile_columns`
folds columns into the fit-time quality profile (`telemetry.quality`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..reliability import names as tnames
from ..reliability.metrics import reliability_metrics
from ..utils import tracing
from .chunk import ChunkSource, default_chunk_rows, make_chunks
from .pool import WorkerPool
from .prefetch import DevicePrefetcher


@dataclasses.dataclass(frozen=True)
class IngestOptions:
    """Knobs for the parallel host ingest path (the estimators' Params
    `num_ingest_workers`, `ingest_mode`, `ingest_chunk_rows` and
    `ingest_prefetch` map onto these 1:1)."""
    num_workers: int = 0        # 0 = all cores; 1 = sequential
    mode: str = "auto"          # process | thread | auto (WorkerPool)
    chunk_rows: int = 0         # 0 = auto (~32 MB of input per chunk)
    prefetch: int = 2           # bounded device-feed depth (double buffer)

    def pool(self, faults=None, metrics=None) -> WorkerPool:
        return WorkerPool(num_workers=self.num_workers, mode=self.mode,
                          faults=faults, metrics=metrics)


def _bin_rows(mapper, rows: np.ndarray) -> np.ndarray:
    """Module-level so the process pool can pickle it by reference. Bins
    at the input's dtype, as the sequential `apply_bins` does (an f32
    downcast of f64 features could flip a searchsorted boundary)."""
    from ..ops import binning
    return binning.apply_bins(mapper, rows)


def parallel_apply_bins(mapper, x: np.ndarray,
                        opts: Optional[IngestOptions] = None,
                        faults=None) -> np.ndarray:
    """Multi-worker `ops.binning.apply_bins`: (n, F) -> (n, F) uint8,
    bit-identical to the sequential call (binning is row-independent)."""
    opts = opts or IngestOptions()
    pool = opts.pool(faults=faults)
    with tracing.wall_clock(tnames.DATA_APPLY_BINS,
                            sink=reliability_metrics.observe):
        return pool.map_rows(functools.partial(_bin_rows, mapper),
                             np.asarray(x),
                             out_width=mapper.n_features,
                             out_dtype=np.uint8,
                             chunk_rows=opts.chunk_rows)


def stage_binned(mapper, x: np.ndarray, opts: Optional[IngestOptions] = None,
                 put: Optional[Callable] = None, faults=None, device=None):
    """Bin on host workers AND stream chunks to the device concurrently:
    chunk k+1 bins while chunk k rides its copy, behind a bounded prefetch
    queue. Returns the (n, F) uint8 bin matrix on `device` (None = the
    card), or, with `put` (the reference's argument: a chunk's host array
    -> its placed tensor), wherever `put` places the chunks.

    When the chunks land on a card the matrix is allocated once and each
    prefetched chunk is copied into its row range (the port's form of the
    reference's donated `dynamic_update_slice`): peak device memory is one
    matrix plus the chunks in flight. Elsewhere the chunks are
    concatenated once."""
    opts = opts or IngestOptions()
    pool = opts.pool(faults=faults)
    x = np.asarray(x)   # bin at the input's dtype, like the serial path
    n = x.shape[0]
    n_features = mapper.n_features
    dev = resolve_device(device) if put is None else None
    fn = functools.partial(_bin_rows, mapper)
    with tracing.wall_clock(tnames.DATA_STAGE_BINNED,
                            sink=reliability_metrics.observe):
        source = (rows for _c, rows in pool.imap_rows(
            fn, x, chunk_rows=opts.chunk_rows))
        with DevicePrefetcher(source, depth=opts.prefetch, put=put,
                              device=dev) as pf:
            buf, lo, parts = None, 0, []
            for dev_chunk in pf:
                if buf is None and dev_chunk.device.type == "cuda":
                    buf = torch.empty((n, n_features), dtype=torch.uint8,
                                      device=dev_chunk.device)
                if buf is None:
                    parts.append(dev_chunk)
                    continue
                hi = lo + dev_chunk.shape[0]
                buf[lo:hi].copy_(dev_chunk)
                lo = hi
            if buf is not None:
                if lo != n:
                    raise RuntimeError(f"staged {lo} of {n} rows")
                return buf
    if not parts:   # zero-row input: an empty matrix, not a crash
        empty = np.zeros((0, n_features), np.uint8)
        return put(empty) if put is not None else torch.from_numpy(
            empty).to(dev)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def profile_columns(profile, columns: dict, chunk_rows: int = 0,
                    max_rows: int = 0):
    """Fold named column arrays into a `telemetry.quality.DatasetProfile`
    in row CHUNKS: the ingest-side reference-profile tap. Each chunk
    merges through the sketches' exact merge (counts sum, Welford
    combine), so a chunked fold gives the state a fleet merge of
    per-worker profiles gives. `max_rows` bounds the fold (0 = all rows);
    the columns are chunked by row range, so they share a row count."""
    if not columns:
        return profile
    names = sorted(columns)
    n = min(int(np.asarray(columns[c]).shape[0]) for c in names)
    if max_rows:
        n = min(n, int(max_rows))
    chunk_rows = chunk_rows or default_chunk_rows(n, len(names), 1)
    for chunk in make_chunks(n, chunk_rows):
        for name in names:
            profile.observe(name,
                            np.asarray(columns[name])[chunk.lo:chunk.hi])
    return profile


class ParallelTransform:
    """Wrap a row-independent Table->Table transform so it maps over row
    chunks on the worker pool with order-preserving reassembly (featurize
    stages over big Tables). Thread-backed (Table transforms close over
    fitted models; the numpy kernels inside release the GIL)."""

    def __init__(self, fn: Callable, opts: Optional[IngestOptions] = None,
                 faults=None):
        self.fn = fn
        self.opts = opts or IngestOptions()
        self._pool = self.opts.pool(faults=faults)

    def __call__(self, table):
        from .chunk import _table_slice, reassemble_tables
        from .pool import _fire_chunk_faults
        n = len(table)
        chunk_rows = self.opts.chunk_rows or default_chunk_rows(
            n, max(len(table.columns), 1), self._pool.num_workers)
        chunks = make_chunks(n, chunk_rows)
        if len(chunks) <= 1:
            return self.fn(table)
        parts = [None] * len(chunks)

        def one(chunk):
            _fire_chunk_faults(self._pool.faults, chunk.index)
            parts[chunk.index] = self.fn(
                _table_slice(table, chunk.lo, chunk.hi))

        with tracing.wall_clock(tnames.DATA_TABLE_TRANSFORM,
                                sink=reliability_metrics.observe):
            self._pool.run_chunks(chunks, one)
        return reassemble_tables(parts, npartitions=table.npartitions)


class IngestPipeline:
    """End-to-end chunked ingest: source -> per-chunk transform (pool) ->
    bounded device prefetch. Iterating yields device-resident chunk
    results in source order; `run()` materializes and returns them all.

        pipe = IngestPipeline(x, transform=binner, opts=IngestOptions())
        for dev_chunk in pipe:        # training consumes while ingest runs
            step(dev_chunk)

    Chunks are copied to `device` (None = the card), as
    `DevicePrefetcher` copies them, or placed by `put` where it is given.
    """

    def __init__(self, source, transform: Callable,
                 opts: Optional[IngestOptions] = None,
                 put: Optional[Callable] = None, faults=None,
                 device=None):
        self.opts = opts or IngestOptions()
        self.source = (source if isinstance(source, ChunkSource)
                       else ChunkSource(source, chunk_rows=self.opts.chunk_rows,
                                        num_workers=self.opts.num_workers
                                        or (WorkerPool(0).num_workers)))
        self.transform = transform
        self._pool = self.opts.pool(faults=faults)
        self._put = put
        self._device = resolve_device(device) if put is None else None

    def __iter__(self):
        arr = self.source.array
        if arr is not None:
            src = (rows for _c, rows in self._pool.imap_rows(
                self.transform, arr, chunk_rows=self.source.chunk_rows))
        else:
            # Table-backed source: transform in chunk order
            src = (self.transform(rows) for _c, rows in self.source)
        # generator, not the raw prefetcher: a consumer that breaks early
        # must still close the feeder thread and drop its pinned buffers
        pf = DevicePrefetcher(src, depth=self.opts.prefetch, put=self._put,
                              device=self._device)

        def consume():
            try:
                for item in pf:
                    yield item
            finally:
                pf.close()
        return consume()

    def run(self) -> list:
        return list(self)
