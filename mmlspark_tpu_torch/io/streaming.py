"""Streaming file ingestion: directory watch -> epoch-batched Tables.

A copy of the reference's `io/streaming.py`, which imports no JAX (role:
the reference's streaming-capable sources —
io/binary/BinaryFileFormat.scala, a Spark FileFormat usable under
readStream, and the epoch mechanics of DistributedHTTPSource), on the
port's Table and data plane, composed with the SAME commit/replay
contract `io/serving.py` uses:

- `get_batch()` returns (epoch, Table|None) of data discovered since the
  last commit. The batch is CACHED until `commit(epoch)`: a consumer that
  dies mid-batch re-reads the identical Table on its next poll (epoch
  replay), no matter how much new data arrived meanwhile.
- `commit(epoch)` advances the source's durable position (per-file byte
  offsets / seen-file set) — positions move ONLY on commit, exactly like a
  streaming checkpoint.

Two modes:
- "binary": every NEW file under the glob whose size held across two
  polls becomes a (path, bytes) row (BinaryFileFormat's reader shape,
  incremental).
- "csv": files are TAILED by byte offset — appended rows stream in as they
  are written; only complete (newline-terminated) lines are consumed, so a
  writer mid-line never produces a torn row. All files share the schema of
  the first header seen; a file whose header differs, or whose reads fail
  more than `_READ_RETRIES` polls in a row, is quarantined.

`FileStreamQuery` is the pull loop: batch -> transform -> sink -> commit,
with replay on failure (same recovery shape as ServingQuery).
"""
from __future__ import annotations

import glob as _glob
import os
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..core import Table


class FileStreamSource:
    """Incremental glob source with epoch/commit/replay semantics."""

    _READ_RETRIES = 5   # consecutive OSErrors on one file before quarantine

    def __init__(self, pattern: str, mode: str = "binary"):
        if mode not in ("binary", "csv"):
            raise ValueError("mode must be binary|csv")
        self.pattern = pattern
        self.mode = mode
        self._epoch = 0
        self._offsets: dict = {}      # csv: path -> committed byte offset
        self._seen: set = set()       # binary: committed file set
        self._sizes: dict = {}        # binary: path -> size at last poll
        self._names: Optional[list] = None   # csv schema (first header)
        self._pending = None          # (epoch, table, next_state) uncommitted
        # _lock guards the tiny state handoff (_pending/_epoch/offsets);
        # _io_lock serializes the glob+read discovery pass SEPARATELY, so
        # commit() and the pending-check never wait behind a slow disk scan
        # (graftlint lock-blocking-call: file reads used to run under _lock)
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        # files whose discovery failed DETERMINISTICALLY (schema drift, or
        # read errors persisting past _READ_RETRIES polls): path -> error.
        # Quarantined so one bad file can't halt the stream; transient
        # OSErrors retry first (a brief EIO/EMFILE blip must not silently
        # drop a file's future data forever).
        self.quarantined: dict = {}
        self._read_failures: dict = {}   # path -> consecutive OSError count

    # -- discovery -----------------------------------------------------------
    def _discover_binary(self):
        """New files whose size is STABLE across two polls — a producer
        mid-write is deferred to the next poll rather than captured
        truncated and lost forever (atomic rename into the directory is
        still the airtight pattern; this guard covers plain writers)."""
        paths = []
        current = sorted(_glob.glob(self.pattern, recursive=True))
        # prune stale sightings: a deleted-then-recreated file must restart
        # its stability window (a stale size equal to a new partial write
        # would defeat the truncation guard), and _sizes must not grow
        # unboundedly in a long-running stream
        live = set(current)
        self._sizes = {p: sz for p, sz in self._sizes.items()
                       if p in live and p not in self._seen}
        for p in current:
            if p in self._seen:
                continue
            try:
                size = os.path.getsize(p)
            except OSError:
                self._sizes.pop(p, None)
                continue
            if self._sizes.get(p) == size:
                paths.append(p)
            else:
                self._sizes[p] = size   # first sighting / still growing
        if not paths:
            return None, None
        blobs = np.empty(len(paths), dtype=object)
        for i, p in enumerate(paths):
            with open(p, "rb") as f:
                blobs[i] = f.read()
        table = Table({"path": np.asarray(paths, dtype=object),
                       "bytes": blobs})
        return table, {"seen": self._seen | set(paths)}

    def _discover_csv(self):
        rows, names = [], self._names
        next_offsets = dict(self._offsets)
        for p in sorted(_glob.glob(self.pattern, recursive=True)):
            if p in self.quarantined:
                continue
            start = self._offsets.get(p, 0)
            try:
                with open(p, "rb") as f:
                    f.seek(start)
                    chunk = f.read()
            except OSError as e:
                # transient read errors retry; only persistent ones
                # quarantine (deterministic drift is quarantined below)
                n_fail = self._read_failures.get(p, 0) + 1
                self._read_failures[p] = n_fail
                if n_fail > self._READ_RETRIES:
                    self.quarantined[p] = e
                continue
            self._read_failures.pop(p, None)
            # consume only complete lines; a torn tail stays for next poll
            cut = chunk.rfind(b"\n")
            if cut < 0:
                continue
            complete, consumed = chunk[:cut + 1], start + cut + 1
            lines = [l for l in complete.split(b"\n") if l.strip()]
            if start == 0 and lines:
                header = [h.strip().decode() for h in lines[0].split(b",")]
                if names is None:
                    names = header
                elif header != names:
                    # quarantine the drifted file, keep the stream flowing
                    # from the conforming ones (inspect source.quarantined)
                    self.quarantined[p] = ValueError(
                        f"{p} header {header} does not match the stream "
                        f"schema {names}")
                    continue
                lines = lines[1:]
            rows.extend(lines)
            next_offsets[p] = consumed
        if not rows or names is None:
            return None, None
        # explicit per-line parse: a ragged or malformed row becomes NaN
        # cells instead of wedging the stream (genfromtxt silently DROPS
        # bad rows, which then breaks the row-count contract)
        mat = np.full((len(rows), len(names)), np.nan, np.float32)
        for i, ln in enumerate(rows):
            parts = ln.split(b",")
            for j in range(min(len(parts), len(names))):
                try:
                    mat[i, j] = float(parts[j])
                except ValueError:
                    pass
        table = Table({nm: mat[:, j] for j, nm in enumerate(names)})
        return table, {"offsets": next_offsets, "names": names}

    # -- source API (ServingServer contract) ---------------------------------
    def get_batch(self):
        """(epoch, Table|None). Uncommitted epochs replay the cached batch.

        Discovery (glob + whole-file reads) runs under `_io_lock` only:
        while a discoverer holds it, `_pending` is None so `commit()` is a
        no-op and the offset/seen state cannot change underneath the scan
        — concurrent `get_batch` callers serialize on the I/O, not on the
        state lock."""
        with self._lock:
            if self._pending is not None:
                return self._pending[0], self._pending[1]
        with self._io_lock:
            with self._lock:
                if self._pending is not None:   # another caller landed one
                    return self._pending[0], self._pending[1]
            # intentional I/O under the DEDICATED discovery lock — that
            # serialization is this lock's entire job
            if self.mode == "binary":
                table, nxt = self._discover_binary()  # graftlint: disable=lock-blocking-call
            else:
                table, nxt = self._discover_csv()  # graftlint: disable=lock-blocking-call
            with self._lock:
                if table is None:
                    return self._epoch, None
                self._pending = (self._epoch, table, nxt)
                return self._epoch, table

    def commit(self, epoch: int) -> None:
        """Advance the durable position; only then does new data flow."""
        with self._lock:
            if self._pending is None or self._pending[0] != epoch:
                return
            nxt = self._pending[2]
            if self.mode == "binary":
                self._seen = nxt["seen"]
            else:
                self._offsets = nxt["offsets"]
                self._names = nxt["names"]
            self._pending = None
            self._epoch = epoch + 1


class FileStreamQuery:
    """Pull loop: batch -> transform -> sink -> commit, with replay on
    failure (the ServingQuery recovery shape on a file source).

    By DEFAULT failed batches replay forever with capped backoff — unlike
    serving (where a bounded replay ends in a visible 502 to the waiting
    client), a file source has no requester to signal, so dropping a batch
    after a few fast retries would silently lose data during a transient
    sink outage. Set MAX_REPLAYS to an int to opt into poison-skipping
    (the skipped batch's error stays in `_errors`)."""

    MAX_REPLAYS: Optional[int] = None   # None = at-least-once, never drop
    MAX_BACKOFF = 1.0

    def __init__(self, source: FileStreamSource, transform_fn: Callable,
                 sink: Callable, poll_interval: float = 0.05,
                 num_workers: int = 1, chunk_rows: int = 0):
        self.source = source
        # num_workers != 1 maps row-independent transforms over row chunks
        # on the parallel ingest pool (data.ParallelTransform) with
        # order-preserving reassembly — the partitioned-micro-batch analog
        # of the reference's per-partition streaming tasks. Output (and
        # therefore the commit/replay contract) is identical to the serial
        # path; a worker failure surfaces like any transform error and the
        # batch replays.
        if num_workers != 1:
            from ..data import IngestOptions, ParallelTransform
            transform_fn = ParallelTransform(
                transform_fn, IngestOptions(num_workers=num_workers,
                                            chunk_rows=chunk_rows))
        self.transform_fn = transform_fn
        self.sink = sink
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._errors: list = []
        self._recoveries = 0

    def start(self) -> "FileStreamQuery":
        self._thread.start()
        return self

    def _work(self):
        replays = 0
        while not self._stop.is_set():
            try:
                # discovery errors (schema drift, unreadable file) must not
                # kill the worker thread silently — record and keep polling
                epoch, table = self.source.get_batch()
            except Exception as e:  # noqa: BLE001
                if len(self._errors) < 1000:
                    self._errors.append(e)
                self._recoveries += 1
                time.sleep(self.poll_interval * 4)
                continue
            if table is None:
                time.sleep(self.poll_interval)
                continue
            try:
                self.sink(self.transform_fn(table))
                self.source.commit(epoch)
                replays = 0
            except Exception as e:  # noqa: BLE001 - worker survives, replays
                if len(self._errors) < 1000:
                    self._errors.append(e)
                self._recoveries += 1
                replays += 1
                if self.MAX_REPLAYS is not None and replays > self.MAX_REPLAYS:
                    # opted-in poison skip: drop the batch, keep streaming
                    self.source.commit(epoch)
                    replays = 0
                else:
                    self._stop.wait(min(self.poll_interval * replays,
                                        self.MAX_BACKOFF))

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
