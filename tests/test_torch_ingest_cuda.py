"""The data plane on the card: the prefetcher's side-stream copies,
`stage_binned` and `ChunkStager` into a device buffer, and
`run_stream`'s in-run restart.

Every test here carries the `gpu` marker and skips without a card. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_ingest_cuda.py
"""
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.data import (ChunkStager, DevicePrefetcher,
                                     IngestOptions, OocoreOptions,
                                     stage_binned)
from mmlspark_tpu_torch.data.prefetch import _StreamCopy
from mmlspark_tpu_torch.models.dnn import ShardedLMTrainer
from mmlspark_tpu_torch.models.dnn.transformer import _flatten
from mmlspark_tpu_torch.ops import binning
from mmlspark_tpu_torch.reliability import (FaultInjector, InjectedFault,
                                            MetricsRegistry)

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

# ~25 ms of GPU time at the H100's clock: queued on the copy stream before
# each copy, it keeps every copy in flight well after the feeder returns
_COPY_DELAY_CYCLES = 50_000_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _items(n=12, size=1 << 22):
    return [np.arange(size, dtype=np.int32) * 3 + i for i in range(n)]


def _delayed(items, stream):
    """Yield each item after queueing a long sleep on the copy stream, so
    its copy lands late (the generator runs on the feeder thread, right
    before the item's copy)."""
    for item in items:
        with torch.cuda.stream(stream):
            torch.cuda._sleep(_COPY_DELAY_CYCLES)
        yield item.copy()     # the only reference: dropped after the copy


@pytest.mark.gpu
def test_prefetch_side_stream_copies_in_order_and_equal(cuda_device):
    """Copies held back on the side stream still reach a fast reader on
    the default stream in order and whole (the reader's stream waits on
    each copy's event); a slow host consumer sees the same; every pinned
    source is released once the stream drains."""
    items = _items()
    sums = torch.tensor([int(a.astype(np.int64).sum()) for a in items])
    for consumer_sleep in (0.0, 0.02):
        metrics = MetricsRegistry()
        copy = _StreamCopy(cuda_device)     # the put of device=cuda
        pf = DevicePrefetcher(_delayed(items, copy.stream), depth=2,
                              put=copy, metrics=metrics)
        got = []
        for t in pf:
            assert t.device.type == "cuda" and t.dtype == torch.int32
            got.append(t.to(torch.int64).sum())      # read at once
            time.sleep(consumer_sleep)
        assert torch.equal(torch.stack(got).cpu(), sums)
        assert metrics.get("data.prefetch.items") == len(items)
        assert not pf._pinned


@pytest.mark.gpu
def test_the_prefetch_check_sees_a_read_before_the_copy(cuda_device):
    """The same reads without the stream wait see wrong data: the delayed
    copies are late enough that the check above is not vacuous."""
    items = _items(n=4)
    copy = _StreamCopy(cuda_device)
    wrong = 0
    for item in _delayed(items, copy.stream):
        flight = copy(item)
        early = flight.tensor.to(torch.int64).sum()   # no wait_event
        wrong += int(early.item() != int(item.astype(np.int64).sum()))
        flight.event.synchronize()
    assert wrong >= 1


def _odd_features(n=100_003, f=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, 0] = rng.integers(0, 5, size=n)
    x[rng.random(x.shape) < 0.02] = np.nan
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_rows", [997, 4096, 100_003])
def test_stage_binned_equals_apply_bins_device(cuda_device, chunk_rows):
    x = _odd_features()
    mapper = binning.fit_bins(x, max_bin=63)
    want = binning.apply_bins_device(mapper, x, device=cuda_device)
    got = stage_binned(mapper, x, IngestOptions(num_workers=4,
                                                chunk_rows=chunk_rows,
                                                prefetch=2),
                       device=cuda_device)
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_chunk_stager_resumes_into_the_device_buffer(cuda_device,
                                                     tmp_path):
    """An injected error at chunk 3 leaves a cursor of 3; the resumed
    stager replays the cached prefix into the device buffer and bins the
    rest: equal to `apply_bins_device`."""
    x = _odd_features(50_001, 5)
    mapper = binning.fit_bins(x, max_bin=31)
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    opts = OocoreOptions(max_resident_bytes=x.nbytes // 8,
                         cache_path=str(tmp_path / "bins.npy"),
                         num_workers=2)
    inj = FaultInjector(seed=1, rules=[
        {"site": "data.oocore.stage3", "kind": "error", "at": [0]}])
    with pytest.raises(InjectedFault):
        ChunkStager(path, mapper, opts, faults=inj).stage(device=cuda_device)
    stager = ChunkStager(path, mapper, opts)
    assert stager.resumed_from == 3 < len(stager.source)
    got = stager.stage(device=cuda_device)
    assert got.device.type == "cuda"
    assert torch.equal(got, binning.apply_bins_device(mapper, x,
                                                      device=cuda_device))


@pytest.mark.gpu
def test_run_stream_in_run_restart_bit_identity(cuda_device, tmp_path):
    """A step crash absorbed in-run on the card: losses and parameters
    equal the uninterrupted supervised run's bit for bit."""
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 128, size=(4, 64)).astype(np.int32)
               for _ in range(6)]
    kw = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              max_len=64, seed=0, device=cuda_device)
    a = ShardedLMTrainer(**kw)
    ref = a.run_stream(batches, checkpoint_dir=str(tmp_path / "a"),
                       checkpoint_every=2)
    b = ShardedLMTrainer(**kw)
    inj = FaultInjector(seed=7, rules=[
        {"site": "train.step3", "kind": "crash", "at": [0]}])
    got = b.run_stream(batches, checkpoint_dir=str(tmp_path / "b"),
                       checkpoint_every=2, faults=inj)
    assert got == ref
    assert all(torch.equal(p, q)
               for p, q in zip(_flatten(a.params), _flatten(b.params)))
