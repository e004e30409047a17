"""Mini-batching on the host: the port's copy of the reference's
`stages/batching.py` (which imports no JAX).

`shape_bucket` and `pad_rows_to_bucket` are what the serving plan cache
(`io/plan.py`) keys and pads on: request batches pad to power-of-two row
counts, so a card stage sees a logarithmic number of batch shapes. The
transformers turn rows into batch rows whose columns hold stacked arrays
(`FixedMiniBatchTransformer`, `DynamicMiniBatchTransformer`,
`TimeIntervalMiniBatchTransformer`) and back (`FlattenBatch`).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..core import Param, Table, Transformer
from ..core.params import in_range


def _stack_rows(col: np.ndarray, bounds) -> np.ndarray:
    out = np.empty(len(bounds), dtype=object)
    for i, (lo, hi) in enumerate(bounds):
        out[i] = col[lo:hi]
    return out


def shape_bucket(n: int, max_bucket: int = 1 << 20) -> int:
    """Smallest power of two >= n (capped): the row-count bucket a card
    stage sees. Padding request batches to these buckets keeps the number
    of distinct batch shapes logarithmic in the max batch size; the
    serving plan cache (io/plan.py) keys its plans on it."""
    if n < 1:
        return 1
    return min(1 << (n - 1).bit_length(), max_bucket)


def pad_rows_to_bucket(arr: np.ndarray, bucket: int) -> np.ndarray:
    """Pad a row-major array to `bucket` rows by repeating the final row.
    Repeating real data (not zeros) keeps padding inside the numeric range
    every row-wise stage already handles — no log(0)/divide-by-zero
    surprises from synthetic rows. Callers slice outputs back to the true
    row count."""
    n = arr.shape[0]
    if n >= bucket:
        return arr
    pad = np.broadcast_to(arr[-1:], (bucket - n,) + arr.shape[1:])
    return np.concatenate([arr, pad], axis=0)


class _BatcherBase(Transformer):
    def _bounds(self, n: int) -> list:
        raise NotImplementedError

    def _transform(self, t: Table) -> Table:
        bounds = self._bounds(len(t))
        return Table({name: _stack_rows(np.asarray(t[name]), bounds)
                      for name in t.columns}, t.npartitions)


class FixedMiniBatchTransformer(_BatcherBase):
    """Fixed-size batches (reference: FixedMiniBatchTransformer; buffered
    producer-thread mode is meaningless on a columnar Table and is omitted).

    `pad_last_batch=True` pads the trailing ragged batch to the full
    batch_size by repeating its final row — every batch then has one shape,
    so a card stage downstream sees one batch shape (the same
    shape-stability contract the serving plan cache keeps with
    `shape_bucket`)."""
    batch_size = Param("batch_size", "rows per batch", 10,
                       validator=in_range(1))
    pad_last_batch = Param("pad_last_batch",
                           "pad the ragged final batch to batch_size by "
                           "repeating its last row (shape-stable batches "
                           "for card stages)", False)

    def _bounds(self, n: int) -> list:
        b = self.batch_size
        return [(i, min(i + b, n)) for i in range(0, n, b)]

    def _transform(self, t: Table) -> Table:
        out = super()._transform(t)
        if not self.pad_last_batch:
            return out
        data = {}
        for name in out.columns:
            col = out[name]
            if len(col) and col[-1].shape[0] < self.batch_size:
                col = col.copy()
                col[-1] = pad_rows_to_bucket(col[-1], self.batch_size)
            data[name] = col
        return Table(data, out.npartitions)


class DynamicMiniBatchTransformer(_BatcherBase):
    """Drain-available batching (reference: DynamicMiniBatchTransformer):
    over a static Table all rows are 'available', so this equals one batch
    capped at max_batch_size — the latency-adaptive behavior lives in the
    serving path (ServingQuery.max_batch)."""
    max_batch_size = Param("max_batch_size", "max rows per batch", 1 << 30)

    def _bounds(self, n: int) -> list:
        b = min(self.max_batch_size, max(n, 1))
        return [(i, min(i + b, n)) for i in range(0, n, b)]


class TimeIntervalMiniBatchTransformer(_BatcherBase):
    """Batch rows arriving within a time window (reference:
    TimeIntervalMiniBatchTransformer). A static Table carries no arrival
    times unless a `timestamp_col` provides them; rows are then grouped into
    `interval_ms` windows."""
    interval_ms = Param("interval_ms", "window length in ms", 1000)
    timestamp_col = Param("timestamp_col", "epoch-seconds column (float)", None)
    max_batch_size = Param("max_batch_size", "cap per batch", 1 << 30)

    def _transform(self, t: Table) -> Table:
        if self.timestamp_col is None or self.timestamp_col not in t:
            return DynamicMiniBatchTransformer(
                max_batch_size=self.max_batch_size).transform(t)
        ts = np.asarray(t[self.timestamp_col], np.float64)
        window = np.floor((ts - ts.min()) / (self.interval_ms / 1000.0))
        bounds = []
        start = 0
        for i in range(1, len(ts) + 1):
            boundary = (i == len(ts) or window[i] != window[start]
                        or i - start >= self.max_batch_size)
            if boundary:
                bounds.append((start, i))
                start = i
        data = {name: _stack_rows(np.asarray(t[name]), bounds)
                for name in t.columns}
        return Table(data, t.npartitions)


class FlattenBatch(Transformer):
    """Inverse of the batchers (reference: FlattenBatch,
    MiniBatchTransformer.scala:16-42): object rows of stacked arrays ->
    plain rows again."""

    def _transform(self, t: Table) -> Table:
        out = {}
        for name in t.columns:
            col = t[name]
            if col.dtype == object and len(col) and isinstance(
                    col[0], np.ndarray):
                flat = np.concatenate([np.asarray(v) for v in col])
            else:
                flat = col
            out[name] = flat
        return Table(out, t.npartitions)
