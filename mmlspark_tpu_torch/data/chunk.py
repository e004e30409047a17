"""Row-range chunking: the Spark-partition analog for host ingest.

Port of the reference's `data/chunk.py` (which imports no JAX). A `Chunk`
is a contiguous [lo, hi) row range, and a `ChunkSource` turns a 2-D array,
a `core.Table` (or a dict of columns) or a memory-mapped `.npy` file into
an ordered list of them.

Design rules that keep the parallel path bit-identical to the sequential
one:
- chunks are CONTIGUOUS and ORDERED — chunk i covers rows strictly before
  chunk i+1, and the union is exactly [0, n). Reassembly is "write chunk
  i's output at rows [lo, hi)", which is order- and schedule-independent.
- chunking never copies: a chunk materializes lazily as a row slice
  (numpy view for arrays, zero-copy column views for Tables).
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

# Auto chunk sizing: big enough that per-chunk dispatch overhead is noise,
# small enough that every worker gets several chunks (tail balance) and a
# chunk's f32 slab stays cache and transfer friendly.
_TARGET_CHUNK_BYTES = 32 << 20     # ~32 MB of f32 input per chunk
_MIN_CHUNK_ROWS = 4096
_MAX_CHUNKS = 4096


class Chunk(NamedTuple):
    """One contiguous row range of a source (the partition stand-in)."""
    index: int
    lo: int
    hi: int

    @property
    def n_rows(self) -> int:
        return self.hi - self.lo


def default_chunk_rows(n_rows: int, n_cols: int, num_workers: int,
                       itemsize: int = 4) -> int:
    """~_TARGET_CHUNK_BYTES per chunk, at least 4 chunks per worker,
    bounded below by _MIN_CHUNK_ROWS so tiny inputs don't shatter into
    overhead, and never more than _MAX_CHUNKS chunks."""
    if n_rows <= 0:
        return 1
    by_bytes = max(_TARGET_CHUNK_BYTES // max(n_cols * itemsize, 1), 1)
    by_balance = max(n_rows // max(4 * num_workers, 1), 1)
    rows = max(min(by_bytes, by_balance), _MIN_CHUNK_ROWS)
    return max(rows, -(-n_rows // _MAX_CHUNKS))


def make_chunks(n_rows: int, chunk_rows: int) -> List[Chunk]:
    """Ordered contiguous cover of [0, n_rows) in chunk_rows steps."""
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    return [Chunk(i, lo, min(lo + chunk_rows, n_rows))
            for i, lo in enumerate(range(0, max(n_rows, 0), chunk_rows))]


class ChunkSource:
    """Splits a row-major source into ordered row-range chunks.

    Accepts a 2-D numpy array, a dict of same-length columns, a Table, or a
    path to an .npy file (opened memory-mapped, so chunk reads stream from
    the page cache instead of materializing the whole file).
    """

    def __init__(self, source, chunk_rows: int = 0, num_workers: int = 1):
        from ..core import Table
        self._table: Optional[Table] = None
        self.array = None
        if isinstance(source, str):
            source = np.load(source, mmap_mode="r")
        if isinstance(source, dict):
            source = Table(source)
        if isinstance(source, Table):
            self._table = source
            self.n_rows = len(source)
            self.n_cols = len(source.columns)
        else:
            self.array = source if isinstance(source, np.memmap) \
                else np.asarray(source)
            if self.array.ndim < 1:
                raise ValueError("ChunkSource needs a row-major source")
            self.n_rows = self.array.shape[0]
            self.n_cols = int(np.prod(self.array.shape[1:])) or 1
        self.chunk_rows = int(chunk_rows) if chunk_rows else \
            default_chunk_rows(self.n_rows, self.n_cols,
                               max(num_workers, 1))
        self.chunks: List[Chunk] = make_chunks(self.n_rows, self.chunk_rows)

    def __len__(self) -> int:
        return len(self.chunks)

    def rows(self, chunk: Chunk):
        """The chunk's rows: array view, or a row-sliced Table."""
        if self._table is not None:
            return _table_slice(self._table, chunk.lo, chunk.hi)
        return self.array[chunk.lo:chunk.hi]

    def __iter__(self) -> Iterator:
        for c in self.chunks:
            yield c, self.rows(c)


def _table_slice(table, lo: int, hi: int):
    """Zero-copy row-range slice of a Table (views, not fancy indexing)."""
    from ..core import Table
    return Table({n: table[n][lo:hi] for n in table.columns}, 1,
                 meta={n: table.column_meta(n) for n in table.columns})


def reassemble_tables(parts: Sequence, npartitions: int = 1):
    """Order-preserving Table reassembly (parts already chunk-ordered)."""
    from ..core import Table
    out = Table.concat_all(list(parts))
    return Table({n: out[n] for n in out.columns}, npartitions,
                 meta={n: out.column_meta(n) for n in out.columns})
