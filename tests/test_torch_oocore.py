"""Port parity: out-of-core staging (`mmlspark_tpu_torch.data.ChunkStager`,
`OocoreOptions`, `ChunkPlanner`) and the fits that ride it, on the CPU.

The invariant everywhere here is bit identity (`np.array_equal` on every
model array), as in tests/test_oocore.py: out-of-core staging, a resumed
staging pass and a chunk drain across hosts move data and nothing else.
A spill cache that the reference's `ChunkStager` staged part of resumes in
the port's (the same fingerprint and sidecar), with bins equal to the
reference's.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu.data import ChunkStager as RefChunkStager
from mmlspark_tpu.data import OocoreOptions as RefOocoreOptions
from mmlspark_tpu.ops import binning as ref_binning
from mmlspark_tpu.reliability.faults import FaultInjector as RefInjector
from mmlspark_tpu.reliability.faults import InjectedFault as RefInjectedFault
from mmlspark_tpu_torch.core import Table
from mmlspark_tpu_torch.data import ChunkPlanner, ChunkStager, OocoreOptions
from mmlspark_tpu_torch.models.gbdt import (BoostParams, GBDTClassifier,
                                            fit_booster,
                                            fit_booster_distributed)
from mmlspark_tpu_torch.ops import binning
from mmlspark_tpu_torch.parallel import data_mesh
from mmlspark_tpu_torch.reliability import (FaultInjector, InjectedFault,
                                            MetricsRegistry)
from mmlspark_tpu_torch.reliability import names as tnames
from mmlspark_tpu_torch.utils.checkpoint import CheckpointManager

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dataset(n=1536, f=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    w = rng.normal(size=f)
    y = (x @ w + rng.normal(scale=0.5, size=n) > 0).astype(np.float32)
    return x, y


def _same_booster(a, b):
    """base + every Booster array field bit-identical."""
    ba, base_a, _ = a
    bb, base_b, _ = b
    assert base_a == base_b
    for field in ba._fields:
        va, vb = getattr(ba, field), getattr(bb, field)
        assert np.array_equal(np.asarray(va), np.asarray(vb)), field


def _params(**kw):
    base = dict(objective="binary", num_iterations=6, num_leaves=15,
                max_depth=4, max_bin=31, min_data_in_leaf=5)
    base.update(kw)
    return BoostParams(**base)


def _fit(x, y, p, **kw):
    return fit_booster(x, y, p, device="cpu", **kw)


# ------------------------------------------------------------ bit identity
def test_oocore_fit_with_weights_equals_in_core(tmp_path):
    """Streaming staging (thread workers, budget << dataset, .npy source)
    fits bit-identically to the in-core path, with sample weights."""
    x, y = _dataset()
    w = np.random.default_rng(3).uniform(0.5, 2.0, size=len(y)) \
        .astype(np.float32)
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    oo = OocoreOptions(max_resident_bytes=x.nbytes // 8,
                       cache_path=str(tmp_path / "bins.npy"),
                       num_workers=2, mode="thread")
    _same_booster(_fit(x, y, _params(), weights=w),
                  _fit(path, y, _params(), weights=w, oocore=oo))


def test_oocore_residency_bound_and_cursor_gauges(tmp_path):
    """The published residency bound stays under the budget and the cursor
    gauge lands at n_chunks once staging drains."""
    x, _ = _dataset()
    reg = MetricsRegistry()
    mapper = binning.fit_bins(x, max_bin=31)
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    budget = x.nbytes // 4
    stager = ChunkStager(path, mapper, OocoreOptions(
        max_resident_bytes=budget, num_workers=1), metrics=reg)
    assert stager.resident_bound <= budget
    assert len(stager.source) > 1
    assert reg.peek_gauge(tnames.DATA_OOCORE_RESIDENT_BYTES) \
        == float(stager.resident_bound)
    d = stager.stage(device="cpu")
    assert np.array_equal(d.numpy(), binning.apply_bins(mapper, x))
    assert stager.cursor == len(stager.source)
    assert reg.peek_gauge(tnames.DATA_OOCORE_CURSOR) \
        == float(len(stager.source))
    assert reg.snapshot()[f"{tnames.DATA_STAGE_BINNED}.count"] == 1


# ------------------------------------------------------------------ resume
def test_oocore_fault_abort_then_resume_bit_identical(tmp_path):
    """An injected error mid-staging leaves a durable cursor; the next
    stager resumes from the cached prefix, and the matrix and a fit riding
    the same cache are bit-identical to an uninterrupted run."""
    x, y = _dataset()
    mapper = binning.fit_bins(x, max_bin=31)
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    cache = str(tmp_path / "bins.npy")
    opts = OocoreOptions(max_resident_bytes=x.nbytes // 8, cache_path=cache)
    inj = FaultInjector(seed=7, rules=[
        {"site": "data.oocore.stage2", "kind": "error", "at": [0]}])
    stager = ChunkStager(path, mapper, opts, faults=inj)
    n_chunks = len(stager.source)
    assert n_chunks > 3
    with pytest.raises(InjectedFault):
        stager.stage(device="cpu")
    with open(cache + ".cursor.json") as f:
        assert json.load(f)["cursor"] == 2   # chunks 0, 1 committed
    resumed = ChunkStager(path, mapper, opts)
    assert resumed.resumed_from == 2
    d = resumed.stage(device="cpu")
    assert resumed.cursor == n_chunks
    assert np.array_equal(d.numpy(), binning.apply_bins(mapper, x))
    _same_booster(_fit(x, y, _params()),
                  _fit(path, y, _params(), oocore=opts))


def test_oocore_stale_fingerprint_invalidates_cursor(tmp_path):
    """A cache written under other bin boundaries is not resumed from."""
    x, _ = _dataset()
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    opts = OocoreOptions(max_resident_bytes=x.nbytes // 8,
                         cache_path=str(tmp_path / "bins.npy"))
    ChunkStager(path, binning.fit_bins(x, max_bin=31), opts).stage(
        device="cpu")
    m15 = binning.fit_bins(x, max_bin=15)
    stager = ChunkStager(path, m15, opts)
    assert stager.resumed_from == 0       # full restage, cursor distrusted
    assert np.array_equal(stager.stage(device="cpu").numpy(),
                          binning.apply_bins(m15, x))


def test_reference_staged_cache_resumes_in_the_port(tmp_path):
    """The reference's ChunkStager stops at an injected error after two
    chunks; the port's stager opens the same cache, resumes from its
    cursor, and the bins equal the reference's."""
    x, _ = _dataset()
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    cache = str(tmp_path / "bins.npy")
    ref_mapper = ref_binning.fit_bins(x, max_bin=31)
    ref_opts = RefOocoreOptions(max_resident_bytes=x.nbytes // 8,
                                cache_path=cache)
    inj = RefInjector(seed=7, rules=[
        {"site": "data.oocore.stage2", "kind": "error", "at": [0]}])
    with pytest.raises(RefInjectedFault):
        RefChunkStager(path, ref_mapper, ref_opts, faults=inj).stage()
    stager = ChunkStager(path, binning.fit_bins(x, max_bin=31),
                         OocoreOptions(max_resident_bytes=x.nbytes // 8,
                                       cache_path=cache))
    assert stager.resumed_from == 2
    got = stager.stage(device="cpu").numpy()
    assert np.array_equal(got, ref_binning.apply_bins(ref_mapper, x))
    assert np.array_equal(
        got, np.asarray(RefChunkStager(path, ref_mapper,
                                       RefOocoreOptions(
                                           max_resident_bytes=x.nbytes // 8)
                                       ).stage()))


_SIGTERM_STAGE = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
from mmlspark_tpu_torch.data import ChunkStager, OocoreOptions
from mmlspark_tpu_torch.ops import binning
from mmlspark_tpu_torch.reliability import FaultInjector

x = np.load({x_path!r}, mmap_mode="r")
mapper = binning.fit_bins(x, max_bin=31, seed=0)
# every chunk sleeps 0.15 s before it commits: staging takes seconds, so
# the parent's poll-then-SIGTERM lands mid-dataset
faults = FaultInjector(seed=0, rules=[
    {{"site": "data.oocore.stage*", "kind": "delay", "prob": 1.0,
      "param": 0.15}}])
oo = OocoreOptions(max_resident_bytes=x.nbytes // 8, cache_path={cache!r})
print("STAGING", flush=True)
ChunkStager({x_path!r}, mapper, oo, faults=faults).stage(device="cpu")
print("DONE", flush=True)
"""


@pytest.mark.chaos
def test_oocore_sigterm_mid_staging_resume_bit_identical(tmp_path):
    """SIGTERM lands mid-dataset in a child that stages with its own delay
    injector; the sidecar cursor survives strictly inside (0, n_chunks),
    and the fit resumed from that cache is bit-identical to an in-core
    fit."""
    x, y = _dataset()
    x_path = str(tmp_path / "x.npy")
    cache = str(tmp_path / "bins.npy")
    np.save(x_path, x)
    script = tmp_path / "stage.py"
    script.write_text(textwrap.dedent(_SIGTERM_STAGE.format(
        repo=_REPO, x_path=x_path, cache=cache)))
    child = subprocess.Popen([sys.executable, str(script)],
                             stdout=subprocess.PIPE, text=True)
    sidecar = cache + ".cursor.json"
    try:
        assert child.stdout.readline().startswith("STAGING")
        deadline = time.time() + 60
        cursor = 0
        while time.time() < deadline and cursor < 2:
            if os.path.exists(sidecar):
                try:
                    with open(sidecar) as f:
                        cursor = json.load(f)["cursor"]
                except (ValueError, KeyError, OSError):
                    cursor = 0
            time.sleep(0.02)
        assert cursor >= 2, "staging never advanced"
        child.send_signal(signal.SIGTERM)
        assert child.wait(timeout=30) == -signal.SIGTERM
    finally:
        if child.poll() is None:
            child.kill()
    with open(sidecar) as f:
        side = json.load(f)
    p = _params()
    oo = OocoreOptions(max_resident_bytes=x.nbytes // 8, cache_path=cache)
    resumed = ChunkStager(x_path, binning.fit_bins(x, max_bin=p.max_bin),
                          oo)
    assert 0 < side["cursor"] < len(resumed.source), side
    assert resumed.resumed_from == side["cursor"]
    _same_booster(_fit(x, y, p), _fit(x_path, y, p, oocore=oo))


def test_estimator_out_of_core_equals_in_core_with_cursor(tmp_path):
    """`out_of_core=True` + `max_resident_bytes` fit the booster of the
    in-core checkpointed fit, the spill cache lands under checkpoint_dir,
    and the staging cursor rides the checkpoint payload."""
    x, y = _dataset(n=1024, f=8)
    t = Table({"features": x, "label": y})
    kw = dict(num_iterations=4, max_bin=31, min_data_in_leaf=5, seed=0,
              checkpoint_interval=2, device="cpu")
    ref = GBDTClassifier(checkpoint_dir=str(tmp_path / "ref"), **kw).fit(t)
    ck = str(tmp_path / "ck")
    oo = GBDTClassifier(out_of_core=True, max_resident_bytes=x.nbytes // 6,
                        checkpoint_dir=ck, **kw).fit(t)
    for field in ref.booster._fields:
        assert np.array_equal(np.asarray(getattr(ref.booster, field)),
                              np.asarray(getattr(oo.booster, field))), field
    assert os.path.exists(os.path.join(ck, "oocore_bins.npy"))
    payload = CheckpointManager(ck).restore()
    assert payload["oocore_cursor"] >= 1
    # a second fit finds the final checkpoint: the same model
    again = GBDTClassifier(out_of_core=True,
                           max_resident_bytes=x.nbytes // 6,
                           checkpoint_dir=ck, **kw).fit(t)
    assert np.array_equal(again.booster.leaf_value, oo.booster.leaf_value)


def test_estimator_ingest_workers_equal_serial():
    x, y = _dataset(n=1024, f=8)
    t = Table({"features": x, "label": y})
    kw = dict(num_iterations=3, max_bin=31, min_data_in_leaf=5,
              device="cpu")
    serial = GBDTClassifier(**kw).fit(t)
    par = GBDTClassifier(num_ingest_workers=3, ingest_mode="thread",
                         ingest_chunk_rows=200, **kw).fit(t)
    for field in serial.booster._fields:
        assert np.array_equal(np.asarray(getattr(serial.booster, field)),
                              np.asarray(getattr(par.booster, field))), field


# ------------------------------------------------------------ the planner
def test_planner_reassign_and_remove_hosts():
    planner = ChunkPlanner(12, hosts=[0, 1, 2])
    assert planner.assigned(2) == [2, 5, 8, 11]
    for idx in planner.assigned(2)[:2]:
        planner.mark_done(idx)             # staged chunks never move
    moved = planner.reassign([{"process_id": 2}])
    assert moved == {8: (2, 0), 11: (2, 1)}
    assert planner.pending(2) == [] and planner.owner(2) == 2
    assert planner.reassign([0, 1, 2]) == {}          # nobody healthy
    moved = planner.remove_hosts([1])
    assert moved == {1: (1, 0), 4: (1, 2), 7: (1, 0), 10: (1, 2),
                     11: (1, 0)}
    assert planner.hosts == [0, 2] and planner.pending(1) == []
    assert planner.remove_hosts([7]) == {}


def test_planner_reassign_fault_skips_round_not_plan():
    inj = FaultInjector(seed=11, rules=[
        {"site": "data.planner.reassign", "kind": "error", "at": [0]}])
    planner = ChunkPlanner(9, hosts=[0, 1, 2], faults=inj)
    before = {i: planner.owner(i) for i in range(9)}
    assert planner.reassign([2]) == {}                 # round skipped
    assert {i: planner.owner(i) for i in range(9)} == before
    moved = planner.reassign([2])                      # next round lands
    assert moved and planner.pending(2) == []


def test_multihost_drain_assembles_bit_identical_fit(tmp_path):
    """Three hosts stage disjoint `only` chunk sets into one shared cache
    in one process; a mid-drain reassignment moves host 2's pending
    chunks; the assembled cache equals a direct binning and the fit over
    it is bit-identical to in-core."""
    x, y = _dataset()
    p = _params()
    mapper = binning.fit_bins(x, max_bin=p.max_bin)
    x_path = str(tmp_path / "x.npy")
    np.save(x_path, x)
    cache = str(tmp_path / "bins.npy")
    opts = OocoreOptions(max_resident_bytes=x.nbytes // 8, cache_path=cache)
    n_chunks = len(ChunkStager(x_path, mapper, opts, only=set()).source)
    assert n_chunks >= 6
    planner = ChunkPlanner(n_chunks, hosts=[0, 1, 2])

    def stage_host(h):
        todo = set(planner.pending(h))
        if todo:
            assert ChunkStager(x_path, mapper, opts, only=todo).stage() \
                is None
            for i in todo:
                planner.mark_done(i)

    stage_host(0)
    moved = planner.reassign([2])
    assert moved and planner.pending(2) == []
    stage_host(1)
    stage_host(0)                          # the chunks it inherited
    assert all(not planner.pending(h) for h in (0, 1, 2))
    assembled = np.array(np.lib.format.open_memmap(cache, mode="r"))
    assert np.array_equal(assembled, binning.apply_bins(mapper, x))
    _same_booster(_fit(x, y, p),
                  _fit(x, y, p, prebinned=(mapper, assembled)))


def test_data_parallel_oocore_equals_in_core(tmp_path):
    """A data-parallel fit over four CPU positions staged out of core (the
    host matrix placed once, then cut by rows) equals the same fit on
    in-core bins."""
    x, y = _dataset(n=1538)       # ragged over 4 positions: padded rows
    p = _params(num_iterations=4)
    path = str(tmp_path / "x.npy")
    np.save(path, x)
    mesh = data_mesh(devices=["cpu"] * 4)
    _same_booster(
        fit_booster_distributed(x, y, p, mesh=mesh),
        fit_booster_distributed(path, y, p, mesh=mesh, oocore=OocoreOptions(
            max_resident_bytes=x.nbytes // 8,
            cache_path=str(tmp_path / "bins.npy"))))
