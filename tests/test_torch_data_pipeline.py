"""Port parity: the data plane's parallel ingest (`mmlspark_tpu_torch.data`:
chunking, the worker pool, the prefetcher, `parallel_apply_bins`,
`stage_binned`) against the JAX package, on the CPU.

The subsystem's contract is that the parallel path is bit-identical to the
sequential one for every worker count, chunk size and backend, so the bins
here are held with `np.array_equal` to the reference's
`parallel_apply_bins` and to the port's own `apply_bins`; the scheduling
properties (bounded queue, released feeder, unstarved consumer) and the
crash semantics (the failing chunk's index) follow
tests/test_data_pipeline.py. A fit whose bins come through the pipeline
equals the port's serial fit bit for bit, and the reference's
`fit_booster(ingest=...)` at tests/test_torch_boosting.py's tolerance.
"""
import functools
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu.data import IngestOptions as RefIngestOptions
from mmlspark_tpu.data import parallel_apply_bins as ref_parallel_apply_bins
from mmlspark_tpu.models.gbdt.boosting import BoostParams as RefParams
from mmlspark_tpu.models.gbdt.boosting import fit_booster as ref_fit
from mmlspark_tpu.ops import binning as ref_binning
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.data import (Chunk, ChunkSource, DevicePrefetcher,
                                     IngestOptions, IngestPipeline,
                                     ParallelTransform, WorkerCrashError,
                                     WorkerPool, make_chunks,
                                     parallel_apply_bins, profile_columns,
                                     stage_binned)
from mmlspark_tpu_torch.data.pipeline import _bin_rows
from mmlspark_tpu_torch.models.gbdt import BoostParams, fit_booster
from mmlspark_tpu_torch.ops import binning
from mmlspark_tpu_torch.reliability import FaultInjector, MetricsRegistry
from test_torch_boosting import _COMMON, _assert_same_model, _data

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)


def _toy_features(n=20_000, f=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    # a low-cardinality column (distinct-value bins, per-feature NaN bin)
    x[:, 0] = rng.integers(0, 5, size=n).astype(np.float32)
    x[rng.random(x.shape) < 0.02] = np.nan
    return x


def _mappers(x, **kw):
    """The port's and the reference's BinMapper of the same rows (the same
    numpy code: equal boundaries)."""
    mine = binning.fit_bins(x, **kw)
    ref = ref_binning.fit_bins(x, **kw)
    np.testing.assert_array_equal(mine.upper_bounds, ref.upper_bounds)
    return mine, ref


# -- chunking ---------------------------------------------------------------

def test_chunks_cover_rows_contiguously_in_order():
    from mmlspark_tpu.data import make_chunks as ref_make_chunks
    chunks = make_chunks(1003, 100)
    assert chunks[0] == Chunk(0, 0, 100)
    assert chunks[-1] == Chunk(10, 1000, 1003)
    for a, b in zip(chunks, chunks[1:]):
        assert a.hi == b.lo and a.index + 1 == b.index
    assert sum(c.n_rows for c in chunks) == 1003
    assert [tuple(c) for c in chunks] == \
        [tuple(c) for c in ref_make_chunks(1003, 100)]


def test_chunk_source_file_backed_npy_and_table(tmp_path):
    x = _toy_features(5000, 4)
    path = str(tmp_path / "rows.npy")
    np.save(path, x)
    src = ChunkSource(path, chunk_rows=1024)
    assert isinstance(src.array, np.memmap)
    got = np.concatenate([rows for _c, rows in src])
    assert np.array_equal(got, x, equal_nan=True)
    t = Table({"a": x[:, 0], "b": x[:, 1:]})
    parts = [rows for _c, rows in ChunkSource(t, chunk_rows=1500)]
    assert [len(p) for p in parts] == [1500, 1500, 1500, 500]
    assert np.array_equal(np.concatenate([np.asarray(p["b"])
                                          for p in parts]), x[:, 1:],
                          equal_nan=True)


# -- determinism: binning ----------------------------------------------------

@pytest.mark.parametrize("num_workers", [1, 2, 4])
def test_parallel_binning_matches_reference(num_workers):
    x = _toy_features()
    mine, ref = _mappers(x, max_bin=63)
    want = ref_parallel_apply_bins(
        ref, x, RefIngestOptions(num_workers=num_workers, mode="thread",
                                 chunk_rows=3000))
    got = parallel_apply_bins(
        mine, x, IngestOptions(num_workers=num_workers, mode="thread",
                               chunk_rows=3000))
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    assert np.array_equal(got, binning.apply_bins(mine, x))


def test_parallel_binning_float64_input_matches_reference():
    # no f32 downcast: f64 values just above their f32 boundary bin
    # exactly as the sequential call bins them
    rng = np.random.default_rng(9)
    x32 = rng.normal(size=(4000, 4)).astype(np.float32)
    mine, ref = _mappers(x32, max_bin=31)
    x64 = x32.astype(np.float64)
    x64[::7] = np.nextafter(x64[::7], np.inf)
    got = parallel_apply_bins(mine, x64,
                              IngestOptions(num_workers=2, chunk_rows=900))
    assert np.array_equal(got, binning.apply_bins(mine, x64))
    assert np.array_equal(got, ref_parallel_apply_bins(
        ref, x64, RefIngestOptions(num_workers=2, chunk_rows=900)))


def test_parallel_binning_categorical_schema_matches_reference():
    x = _toy_features(6000, 5)
    mine, ref = _mappers(x, max_bin=63, categorical_features=(0,))
    got = parallel_apply_bins(mine, x,
                              IngestOptions(num_workers=3, chunk_rows=1000))
    assert np.array_equal(got, binning.apply_bins(mine, x))
    assert np.array_equal(got, ref_parallel_apply_bins(
        ref, x, RefIngestOptions(num_workers=3, chunk_rows=1000)))


def test_parallel_binning_process_backend_matches_reference():
    # the shared-memory spawn pool, forced on small data
    x = _toy_features(8000, 6)
    mine, ref = _mappers(x, max_bin=31)
    got = parallel_apply_bins(
        mine, x, IngestOptions(num_workers=2, mode="process",
                               chunk_rows=3000))
    assert np.array_equal(got, binning.apply_bins(mine, x))
    assert np.array_equal(got, ref_binning.apply_bins(ref, x))


def test_auto_mode_picks_threads_where_the_reference_does():
    fn = functools.partial(_bin_rows, binning.fit_bins(_toy_features(100)))
    pool = WorkerPool(num_workers=4, mode="auto")
    assert pool._pick_mode(fn, 1 << 20) == "thread"      # small input
    assert pool._pick_mode(fn, 1 << 30) == "process"     # large, picklable
    assert pool._pick_mode(lambda r: r, 1 << 30) == "thread"   # unpicklable
    assert WorkerPool(num_workers=1)._pick_mode(fn, 1 << 30) == "thread"


def test_many_thread_workers_under_fast_switching_stay_bit_identical():
    """More workers than cores, ~200 small chunks and a very short thread
    switch interval: every chunk's rows still land in their own range."""
    x = _toy_features(20_000, 4)
    mapper = binning.fit_bins(x, max_bin=31)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = parallel_apply_bins(mapper, x, IngestOptions(
            num_workers=16, mode="thread", chunk_rows=97))
        staged = stage_binned(mapper, x, IngestOptions(
            num_workers=16, chunk_rows=97, prefetch=1), device="cpu")
    finally:
        sys.setswitchinterval(interval)
    want = binning.apply_bins(mapper, x)
    assert np.array_equal(got, want)
    assert np.array_equal(staged.numpy(), want)


def test_stage_binned_on_the_cpu_matches_sequential():
    x = _toy_features(12_000, 5)
    mapper = binning.fit_bins(x, max_bin=63)
    seq = binning.apply_bins(mapper, x)
    for chunk_rows in (2000, 5000, 12_000):
        d = stage_binned(mapper, x, IngestOptions(num_workers=2,
                                                  chunk_rows=chunk_rows),
                         device="cpu")
        assert d.device.type == "cpu" and d.dtype == torch.uint8
        assert np.array_equal(d.numpy(), seq), chunk_rows
    empty = stage_binned(mapper, x[:0], IngestOptions(num_workers=2),
                         device="cpu")
    assert tuple(empty.shape) == (0, 5)


def test_stage_binned_and_pipeline_take_the_reference_s_put():
    """ROADMAP Queue 3 (w): `put=` places each chunk (the reference's
    argument); the bins equal the sequential ones."""
    x = _toy_features(6000, 5)
    mapper = binning.fit_bins(x, max_bin=63)
    placed = []

    def put(rows):
        placed.append(rows.shape[0])
        return torch.from_numpy(np.asarray(rows))
    d = stage_binned(mapper, x, IngestOptions(num_workers=2,
                                              chunk_rows=1000), put=put)
    assert np.array_equal(d.numpy(), binning.apply_bins(mapper, x))
    assert sum(placed) == 6000 and len(placed) == 6
    pipe = IngestPipeline(x, transform=lambda rows: rows * 2,
                          opts=IngestOptions(num_workers=2, chunk_rows=1000),
                          put=lambda rows: ("placed", rows.shape[0]))
    assert pipe.run() == [("placed", 1000)] * 6


def test_prefetch_queue_depth_reports_ready_items():
    """ROADMAP Queue 3 (w): `DevicePrefetcher.queue_depth()`."""
    pf = DevicePrefetcher(range(3), depth=3, put=lambda v: v)
    assert pf.queue_depth() == 0
    it = iter(pf)
    deadline = time.time() + 5
    while pf.queue_depth() < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert pf.queue_depth() == 3    # full: the end marker waits behind
    assert list(it) == [0, 1, 2]
    pf.close()


def test_parallel_transform_and_pipeline_reassemble_in_order():
    x = _toy_features(8000, 4)
    t = Table({"a": x[:, 0], "b": x[:, 1:]})
    double = ParallelTransform(
        lambda tb: tb.with_column("a", np.asarray(tb["a"]) * 2),
        IngestOptions(num_workers=3, chunk_rows=1000))
    out = double(t)
    assert np.array_equal(np.asarray(out["a"]), x[:, 0] * 2, equal_nan=True)
    pipe = IngestPipeline(x, transform=lambda rows: rows * 2,
                          opts=IngestOptions(num_workers=2, chunk_rows=1000),
                          device="cpu")
    got = torch.cat(pipe.run()).numpy()
    assert np.array_equal(got, x * 2, equal_nan=True)


def test_ingest_pipeline_early_break_closes_feeder():
    x = _toy_features(8000, 4)
    pipe = IngestPipeline(x, transform=lambda rows: rows * 2,
                          opts=IngestOptions(num_workers=2, chunk_rows=1000),
                          device="cpu")
    it = iter(pipe)
    next(it)
    it.close()    # early break: the generator's finally closes the feeder
    deadline = time.time() + 5
    while time.time() < deadline and any(
            t.name == "ingest-prefetch" and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.05)
    assert not any(t.name == "ingest-prefetch" and t.is_alive()
                   for t in threading.enumerate())


def test_profile_columns_names_its_item():
    """profile_columns, once a raise naming item 23, folds columns chunk
    by chunk into a profile equal to the reference's (ROADMAP Queue 3
    (p))."""
    from mmlspark_tpu.data.pipeline import profile_columns as ref_profile
    from mmlspark_tpu.telemetry import quality as ref_quality
    from mmlspark_tpu_torch.telemetry import quality
    rng = np.random.default_rng(3)
    cols = {"a": rng.normal(size=1000), "b": rng.integers(0, 5, 1000)}
    got = quality.DatasetProfile.fit(cols, categorical=("b",),
                                     observe=False)
    want = ref_quality.DatasetProfile.fit(cols, categorical=("b",),
                                          observe=False)
    profile_columns(got, cols, chunk_rows=128)
    ref_profile(want, cols, chunk_rows=128)
    assert got.state() == want.state()
    assert got.columns["a"].count == 1000


# -- the prefetcher -----------------------------------------------------------

def test_prefetch_copies_to_the_device_asked_for():
    items = [np.arange(6, dtype=np.int32).reshape(2, 3) + i for i in range(4)]
    with DevicePrefetcher(iter(items), depth=2, device="cpu",
                          metrics=MetricsRegistry()) as pf:
        got = list(pf)
    assert all(torch.is_tensor(g) and g.device.type == "cpu" for g in got)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, items))


def test_prefetch_queue_is_bounded():
    depth = 2
    produced = []

    def put(item):
        produced.append(item)
        return item

    metrics = MetricsRegistry()
    pf = DevicePrefetcher(range(12), depth=depth, put=put, metrics=metrics)
    consumed = 0
    for _ in pf:
        consumed += 1
        time.sleep(0.01)   # slow consumer: the feeder must block, not race
        # at most: `depth` queued + 1 being handed over + 1 inside put()
        assert len(produced) - consumed <= depth + 2, \
            (len(produced), consumed)
    assert consumed == 12 and len(produced) == 12
    assert metrics.get("data.prefetch.items") == 12


def test_prefetch_close_releases_blocked_feeder():
    pf = DevicePrefetcher(range(100), depth=1, put=lambda x: x)
    it = iter(pf)
    next(it)
    pf.close()     # a feeder blocked on the full queue exits promptly
    pf._thread.join(timeout=2)
    assert not pf._thread.is_alive()


def test_prefetch_keeps_consumer_unstarved():
    """The producer is faster than the consumer: after the first batch the
    consumer never finds the queue empty."""
    metrics = MetricsRegistry()

    def slow_put(item):
        time.sleep(0.01)
        return item

    pf = DevicePrefetcher(range(10), depth=2, put=slow_put, metrics=metrics)
    n = 0
    for _ in pf:
        time.sleep(0.025)   # consumer strictly slower than producer
        n += 1
    assert n == 10
    assert metrics.get("data.prefetch.stalls") <= 1, metrics.snapshot()
    assert pf.stalls == metrics.get("data.prefetch.stalls")
    assert metrics.get("data.prefetch.full") >= 1   # backpressure engaged


# -- crash propagation -------------------------------------------------------

def test_worker_crash_propagates_with_chunk_index():
    inj = FaultInjector(seed=7, rules=[
        {"site": "data.worker.chunk2", "kind": "crash", "at": [0]}])
    metrics = MetricsRegistry()
    pool = WorkerPool(num_workers=2, mode="thread", faults=inj,
                      metrics=metrics)
    x = _toy_features(5000, 4)
    with pytest.raises(WorkerCrashError) as ei:
        pool.map_rows(lambda rows: rows * 2, x, out_width=4,
                      chunk_rows=1000)
    assert ei.value.chunk_index == 2
    assert metrics.get("data.worker_failures") >= 1
    assert ("data.worker.chunk2", 0, "crash") in inj.schedule()


def test_worker_crash_propagates_from_process_pool():
    # a passed injector fires inside the spawned workers too
    inj = FaultInjector(seed=5, rules=[
        {"site": "data.worker.chunk1", "kind": "crash", "at": [0]}])
    metrics = MetricsRegistry()
    pool = WorkerPool(num_workers=2, mode="process", faults=inj,
                      metrics=metrics)
    x = _toy_features(6000, 4)
    mapper = binning.fit_bins(x, max_bin=31)
    with pytest.raises(WorkerCrashError) as ei:
        pool.map_rows(functools.partial(_bin_rows, mapper), x, out_width=4,
                      out_dtype=np.uint8, chunk_rows=2000)
    assert ei.value.chunk_index == 1
    assert "InjectedCrash" in str(ei.value)
    assert metrics.get("data.worker_failures") >= 1


def test_worker_crash_propagates_through_staged_feed():
    inj = FaultInjector(seed=7, rules=[
        {"site": "data.worker.chunk1", "kind": "error", "at": [0]}])
    x = _toy_features(6000, 4)
    mapper = binning.fit_bins(x, max_bin=31)
    with pytest.raises(WorkerCrashError) as ei:
        stage_binned(mapper, x, IngestOptions(num_workers=2,
                                              chunk_rows=2000),
                     faults=inj, device="cpu")
    assert ei.value.chunk_index == 1


def test_seeded_crash_schedule_is_reproducible():
    rules = [{"site": "data.worker.chunk*", "kind": "error", "prob": 0.5}]
    histories = []
    for _ in range(2):
        inj = FaultInjector(seed=13, rules=rules)
        pool = WorkerPool(num_workers=3, mode="thread", faults=inj,
                          metrics=MetricsRegistry())
        with pytest.raises(WorkerCrashError):
            pool.map_rows(lambda r: r, _toy_features(4000, 3), out_width=3,
                          chunk_rows=500)
        histories.append(sorted(inj.schedule()))
    assert histories[0] == histories[1] and histories[0]


# -- the fit ------------------------------------------------------------------

@pytest.mark.parametrize("valid", [False, True])
def test_fit_booster_ingest_matches_serial_and_reference(valid):
    """The ingest-staged fit equals the port's serial fit bit for bit, and
    the reference's ingest fit at test_torch_boosting.py's tolerance."""
    x, y = _data("binary")
    kw = dict(_COMMON, objective="binary", num_iterations=4)
    fit_kw = {}
    if valid:
        vx, vy = _data("binary", n=500, seed=9)
        fit_kw = dict(valid=(vx, vy))
    serial = fit_booster(x, y, BoostParams(**kw), device="cpu", **fit_kw)
    got = fit_booster(x, y, BoostParams(**kw), device="cpu",
                      ingest=IngestOptions(num_workers=3, chunk_rows=700),
                      **fit_kw)
    for field in serial[0]._fields:
        assert np.array_equal(np.asarray(getattr(serial[0], field)),
                              np.asarray(getattr(got[0], field))), field
    assert serial[1] == got[1] and serial[2] == got[2]
    ref_b, ref_base, ref_hist = ref_fit(
        x, y, RefParams(**kw),
        ingest=RefIngestOptions(num_workers=3, chunk_rows=700), **fit_kw)
    assert got[1] == ref_base
    _assert_same_model(got[0], ref_b,
                       binning.apply_bins(binning.fit_bins(x, max_bin=63,
                                                           seed=0), x))
    np.testing.assert_allclose(got[2], ref_hist, rtol=1e-4)
