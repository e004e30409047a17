"""Out-of-core staging: stream chunked binning under a bounded residency
budget, with a durable mid-dataset resume cursor.

Port of the reference's `data/oocore.py`. `ChunkStager` walks a
`ChunkSource` (typically a memory-mapped .npy far larger than RAM) in
contiguous row-range chunks, bins each chunk on the worker pool, and lands
the uint8 result either directly in a device buffer (a card: the matrix is
allocated once and each chunk copied into its row range) or in a host
array / the disk-backed spill cache that is placed once (the CPU, a mesh,
a caller's `put`). Two invariants:

- **Residency budget.** `max_resident_bytes` bounds the RAW bytes
  host-resident at once: chunk_rows is derived so that the bounded
  in-flight window (pool workers + queue slack) times the per-chunk slab
  stays under the budget. The bound is published as the
  `data.oocore.resident_bytes` gauge; the binned uint8 output is the only
  full-size artifact (device-resident, or the spill cache on disk).
- **Durable cursor.** With a `cache_path`, every chunk's binned rows are
  flushed to a `.npy` memmap and the chunk index is committed to an
  atomically-replaced sidecar (`<cache>.cursor.json`, fsynced before the
  rename) — the `data.oocore.cursor` gauge. A staging pass killed
  mid-dataset (SIGTERM, preemption, an injected `data.oocore.stage{index}`
  fault) resumes by reloading the cached prefix and binning only the
  remainder; binning is deterministic and chunks are written by row range,
  so the resumed matrix — and therefore the fit — is bit-identical to an
  uninterrupted run. The cache's fingerprint is computed as the
  reference's, so a cache that either package staged part of resumes in
  the other.

Chunk ordering and row-range writes also make the output independent of
WHICH host bins a chunk (the `only` subset), which `ChunkPlanner`
(planner.py) relies on.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..reliability import names as tnames
from ..reliability.metrics import reliability_metrics
from ..utils import tracing
from .chunk import Chunk, ChunkSource
from .pipeline import _bin_rows
from .pool import WorkerPool


@dataclasses.dataclass(frozen=True)
class OocoreOptions:
    """Knobs for the out-of-core staging path (the estimator Params
    `out_of_core` / `max_resident_bytes` map onto these)."""
    max_resident_bytes: int = 0   # 0 = one auto-sized (~32 MB) chunk window
    cache_path: Optional[str] = None  # binned spill cache; None = no resume
    num_workers: int = 1          # 0 = all cores; 1 = sequential
    mode: str = "thread"          # thread | process (binning backend)
    chunk_rows: int = 0           # explicit override (wins over the budget)
    prefetch: int = 2             # device-feed queue slack (window term)


def _cache_fingerprint(n: int, n_features: int, chunk_rows: int,
                       mapper) -> str:
    """Identity of a spill cache: shape, chunking, and the exact bin
    boundaries. A cache written under ANY other fingerprint is stale —
    resuming from it would splice differently-binned rows together."""
    h = hashlib.sha1()
    h.update(repr((n, n_features, chunk_rows, int(mapper.max_bin))).encode())
    h.update(np.ascontiguousarray(mapper.upper_bounds).tobytes())
    h.update(np.ascontiguousarray(mapper.n_bins).tobytes())
    if mapper.categorical is not None:
        h.update(np.ascontiguousarray(mapper.categorical).tobytes())
    return h.hexdigest()


class ChunkStager:
    """Stream chunked binning into device/cache residency (module doc).

    `only` restricts this stager to a subset of chunk indices — the
    multi-host split, where each host stages the chunks a `ChunkPlanner`
    assigned to it into a shared cache and nobody owns the whole matrix.
    The durable cursor tracks the contiguous done-prefix, so single-host
    resume is exact while multi-host staging stays coordination-free.
    """

    def __init__(self, x, mapper, opts: Optional[OocoreOptions] = None,
                 faults=None, metrics=None,
                 only: Optional[set] = None):
        """`faults=None` injects nothing."""
        self.opts = opts or OocoreOptions()
        self.mapper = mapper
        self.metrics = metrics if metrics is not None else reliability_metrics
        self.pool = WorkerPool(num_workers=self.opts.num_workers,
                               mode=self.opts.mode,
                               faults=faults, metrics=self.metrics)
        self.faults = self.pool.faults
        arr = np.load(x, mmap_mode="r") if isinstance(x, str) else x
        if not hasattr(arr, "shape") or getattr(arr, "ndim", 0) != 2:
            raise ValueError("out-of-core staging needs a 2-D row-major "
                             "array or an .npy path")
        n, n_features = arr.shape
        if n_features != mapper.n_features:
            raise ValueError(f"source has {n_features} features but the "
                             f"mapper bins {mapper.n_features}")
        row_bytes = n_features * arr.dtype.itemsize
        # bounded in-flight window: workers + the imap queue slack
        # (bounded_map holds num_workers+2) + prefetch + the chunk being
        # consumed — every raw slab that can be live at once
        self._window = self.pool.num_workers + 3 + max(
            int(self.opts.prefetch), 0)
        if self.opts.chunk_rows:
            chunk_rows = int(self.opts.chunk_rows)
        elif self.opts.max_resident_bytes:
            chunk_rows = max(
                int(self.opts.max_resident_bytes)
                // max(row_bytes * self._window, 1), 1)
        else:
            chunk_rows = 0   # ChunkSource's ~32 MB auto sizing
        self.source = ChunkSource(arr, chunk_rows=chunk_rows,
                                  num_workers=self.pool.num_workers)
        self.n_rows, self.n_features = n, n_features
        self.resident_bound = self.source.chunk_rows * row_bytes \
            * min(self._window, len(self.source))
        self.only = None if only is None else set(int(i) for i in only)
        self._fp = _cache_fingerprint(n, n_features, self.source.chunk_rows,
                                      mapper)
        self._cache = None
        self._sidecar = None
        self.resumed_from = 0
        if self.opts.cache_path is not None:
            self._open_cache(self.opts.cache_path)
        self._cursor = self.resumed_from
        self.metrics.set_gauge(tnames.DATA_OOCORE_RESIDENT_BYTES,
                               float(self.resident_bound))
        self.metrics.set_gauge(tnames.DATA_OOCORE_CURSOR,
                               float(self._cursor))

    # -- spill cache ---------------------------------------------------------
    def _open_cache(self, path: str) -> None:
        self._sidecar = path + ".cursor.json"
        shape = (self.n_rows, self.n_features)
        cursor = 0
        if os.path.exists(path) and os.path.exists(self._sidecar):
            try:
                with open(self._sidecar, encoding="utf-8") as f:
                    side = json.load(f)
                if side.get("fingerprint") == self._fp:
                    cursor = int(side.get("cursor", 0))
            except (OSError, ValueError):
                cursor = 0
        cache = None
        if os.path.exists(path):
            # reuse a shape/dtype-compatible file even at cursor 0: in
            # the multi-host (`only`) split several stagers share one
            # cache path, and recreating it would zero chunks another
            # host already staged. Every row we are responsible for gets
            # rewritten anyway, so a stale fingerprint only invalidates
            # the CURSOR (handled above), never the reuse.
            try:
                cache = np.lib.format.open_memmap(path, mode="r+")
                if cache.shape != shape or cache.dtype != np.uint8:
                    cursor, cache = 0, None
            except (OSError, ValueError):
                cursor, cache = 0, None
        if cache is None:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            cache = np.lib.format.open_memmap(path, mode="w+",
                                              dtype=np.uint8, shape=shape)
        self._cache = cache
        # the cursor is trusted only up to the chunks that fully flushed;
        # a multi-host (`only`) stager never advances it (no host owns
        # the contiguous prefix)
        self.resumed_from = cursor if self.only is None else 0

    @property
    def cursor(self) -> int:
        """Chunks durably staged so far (== n_chunks once staging is
        done) — what rides the supervisor checkpoint payload."""
        return self._cursor

    def _commit(self, index: int) -> None:
        """Durably advance the cursor past chunk `index` (in-order)."""
        self._cursor = index + 1
        self.metrics.set_gauge(tnames.DATA_OOCORE_CURSOR,
                               float(self._cursor))
        if self._cache is None or self.only is not None:
            return
        self._cache.flush()
        tmp = self._sidecar + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"cursor": self._cursor, "fingerprint": self._fp}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._sidecar)

    # -- chunked binning -----------------------------------------------------
    def _fresh_chunks(self):
        """Yield (chunk, binned_rows) for every chunk past the resume
        cursor, in chunk order, bound by the residency window."""
        chunks = self.source.chunks[self.resumed_from:]
        if not chunks:
            return
        x = self.source.array
        fn = functools.partial(_bin_rows, self.mapper)
        if self.opts.mode == "process":
            # process workers can't stream (shared-memory batch IPC):
            # bin in groups of `window` chunks — the group slab IS the
            # declared residency bound, copied once into shm and
            # released. Each map_rows call spawns a fresh worker set, so
            # grouping below the window would multiply spawn rounds
            # without lowering peak residency.
            group = max(self._window, 1)
            for g in range(0, len(chunks), group):
                gch = chunks[g:g + group]
                lo, hi = gch[0].lo, gch[-1].hi
                batch = np.ascontiguousarray(x[lo:hi])
                res = self.pool.map_rows(fn, batch,
                                         out_width=self.n_features,
                                         out_dtype=np.uint8,
                                         chunk_rows=self.source.chunk_rows)
                for c in gch:
                    yield c, res[c.lo - lo:c.hi - lo]
            return
        # thread backend: bounded ordered streaming (numpy binning drops
        # the GIL), at most window slabs in flight
        base = chunks[0]
        for c, binned in self.pool.imap_rows(
                fn, x[base.lo:], chunk_rows=self.source.chunk_rows):
            yield Chunk(c.index + base.index, c.lo + base.lo,
                        c.hi + base.lo), binned

    # -- staging -------------------------------------------------------------
    def stage(self, put=None, device=None):
        """Run the staging pass; returns the (n, F) uint8 bin matrix: on a
        card (`device`, None = the card) a device buffer that each chunk
        is copied into (the cached prefix first, on resume); otherwise the
        host matrix (the spill cache when there is one) placed once, by
        `put` when given (a mesh's row placement) or onto `device`.

        With `only` set, stages just this host's chunks into the shared
        cache and returns None — the caller places the assembled cache
        once every host has drained (see ChunkPlanner)."""
        with tracing.wall_clock(tnames.DATA_STAGE_BINNED,
                                sink=self.metrics.observe):
            dev = None
            if self.only is None and put is None:
                dev = resolve_device(device)
            buf = None
            if dev is not None and dev.type == "cuda":
                buf = torch.empty((self.n_rows, self.n_features),
                                  dtype=torch.uint8, device=dev)
                if self.resumed_from:
                    # replay the cached prefix into the device buffer
                    done = self.source.chunks[self.resumed_from - 1].hi
                    buf[:done].copy_(torch.from_numpy(
                        np.ascontiguousarray(self._cache[:done])))
            dest = self._cache
            if dest is None and buf is None:
                dest = np.empty((self.n_rows, self.n_features), np.uint8)
            for chunk, binned in self._fresh_chunks():
                if self.only is not None and chunk.index not in self.only:
                    continue
                if self.faults is not None:
                    self.faults.perturb(f"data.oocore.stage{chunk.index}")
                if dest is not None:
                    dest[chunk.lo:chunk.hi] = binned
                if buf is not None:
                    buf[chunk.lo:chunk.hi].copy_(torch.from_numpy(binned))
                self._commit(chunk.index)
            if self.only is not None:
                return None
            if buf is not None:
                return buf
            if put is not None:
                return put(dest)
            # a copy: the spill cache's memory map stays the file's
            return torch.from_numpy(np.array(dest)).to(dev)
