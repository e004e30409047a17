"""Port parity: step checkpoints (`mmlspark_tpu_torch.utils.checkpoint`)
and the background writer (`reliability.supervisor.AsyncCheckpointWriter`)
against the reference, on the CPU.

The on-disk format is the reference's, so steps written by either
package restore in the other; a torn or silently corrupted newest step
falls back to the next-newest readable one; the writer never blocks its
caller and absorbs a failed background write (the reference's
tests/test_supervisor.py and tests/test_checkpoint_tracing.py cases,
driven here through the writer itself: the supervisor loop is ROADMAP
Queue 1 item 17).
"""
import json
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.utils.checkpoint import \
    CheckpointManager as RefCheckpointManager
from mmlspark_tpu_torch.reliability import (AsyncCheckpointWriter,
                                            FaultInjector, InjectedFault,
                                            reliability_metrics)
from mmlspark_tpu_torch.utils.checkpoint import CheckpointManager

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)


def _payload(step):
    return {"w": np.arange(step * 4, dtype=np.float32).reshape(step, 4),
            "margin": np.linspace(-1, 1, 7).astype(np.float32),
            "iteration": step, "booster": f"tree {step}.25", "final": False,
            "meta": {"n_heads": 2, "d_model": 32}}


def _equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("writer,reader", [
    (RefCheckpointManager, CheckpointManager),
    (CheckpointManager, RefCheckpointManager)])
def test_steps_cross_packages(tmp_path, writer, reader):
    """Steps written by one package restore in the other, digests and
    all; the latest and an explicit step."""
    w = writer(str(tmp_path / "ck"))
    for step in (1, 2):
        w.save(step, _payload(step))
    r = reader(str(tmp_path / "ck"))
    assert r.all_steps() == [1, 2] and r.latest_step() == 2
    got, step = r.restore(with_step=True)
    assert step == 2
    _equal(got, _payload(2))
    _equal(r.restore(1), _payload(1))
    with open(os.path.join(tmp_path, "ck", "step_2", "meta.json")) as f:
        assert len(json.load(f)["_digests"]["payload.npz"]) == 64


def test_corrupt_newest_falls_back(tmp_path):
    """A truncated newest payload, then a garbage meta.json, each cost one
    step; every step unreadable is a clear error; an explicit corrupt step
    raises."""
    reliability_metrics.reset(prefix="checkpoint.")
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    for step in (1, 2, 3):
        mgr.save(step, {"w": np.arange(step, dtype=np.float32),
                        "iteration": step})
    FaultInjector(seed=13).corrupt_file(
        os.path.join(mgr._step_dir(3), "payload.npz"))
    out = mgr.restore()
    assert out["iteration"] == 2
    np.testing.assert_allclose(out["w"], np.arange(2))
    assert reliability_metrics.get("checkpoint.corrupt_skipped") == 1
    with pytest.raises(Exception):
        mgr.restore(3)
    with open(os.path.join(mgr._step_dir(2), "meta.json"), "w") as f:
        f.write("{corrupt json")
    assert mgr.restore()["iteration"] == 1
    FaultInjector(seed=13).corrupt_file(
        os.path.join(mgr._step_dir(1), "payload.npz"), site="ck2")
    with open(os.path.join(mgr._step_dir(1), "meta.json"), "w") as f:
        f.write("{")
    with pytest.raises(RuntimeError, match="unreadable"):
        mgr.restore()


@pytest.mark.parametrize("what", ["payload", "meta"])
def test_digest_mismatch_skipped(tmp_path, what):
    """Silent corruption that stays readable (a valid npz of other data; a
    model string edited inside valid JSON) fails the sha256 gate and falls
    back, as the reference does."""
    reliability_metrics.reset(prefix="checkpoint.")
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    for s in (1, 2, 3):
        mgr.save(s, {"w": np.arange(s * 4, dtype=np.float32),
                     "iteration": s, "booster": f"tree {s}.25"})
    if what == "payload":
        np.savez(os.path.join(mgr._step_dir(3), "payload.npz"),
                 w=np.zeros(12, np.float32))
    else:
        path = os.path.join(mgr._step_dir(3), "meta.json")
        with open(path) as f:
            meta = json.load(f)
        meta["booster"] = "tree 0.00"
        with open(path, "w") as f:
            json.dump(meta, f)
    out = mgr.restore()
    assert out["iteration"] == 2
    np.testing.assert_array_equal(out["w"], np.arange(8, dtype=np.float32))
    assert reliability_metrics.get("checkpoint.digest_mismatch") >= 1
    with pytest.raises(ValueError, match="sha256 mismatch"):
        mgr.restore(3)


def test_retention_pruning_and_reserved_keys(tmp_path):
    """max_to_keep, prune_newer (a truncating save leaves no higher step
    to shadow it), stale temporary directories, save metrics and the
    reserved `_` keys."""
    reliability_metrics.reset(prefix="checkpoint.save")
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in (5, 10, 15):
        mgr.save(step, {"w": np.arange(step, dtype=np.float32),
                        "iteration": step})
    assert mgr.all_steps() == [10, 15]
    assert reliability_metrics.get("checkpoint.save.count") == 3
    assert reliability_metrics.get("checkpoint.save.bytes") > 0
    mgr.save(12, {"iteration": 12, "final": True}, prune_newer=True)
    assert mgr.all_steps() == [10, 12]
    assert mgr.restore()["final"] is True
    os.makedirs(tmp_path / "ck" / ".tmp_dead", exist_ok=True)
    assert mgr.latest_step() == 12
    with pytest.raises(ValueError, match="reserved"):
        mgr.save(13, {"_digests": {}})


def test_async_writer_never_blocks_its_caller(tmp_path):
    """With 50 ms injected into every write and a queue of one, submit
    stays far cheaper than a write, the queue coalesces (latest wins)
    instead of blocking, and the final synchronous write is the newest
    state."""
    reliability_metrics.reset()
    inj = FaultInjector(seed=3, rules=[
        {"site": "train.ckpt.write", "kind": "delay", "param": 0.05,
         "prob": 1.0}])
    mgr = CheckpointManager(str(tmp_path / "ck"))
    writer = AsyncCheckpointWriter(mgr, depth=1, faults=inj)
    x = np.zeros(3)
    for step in range(1, 10):
        x = x + step
        writer.submit(step, {"x": x.copy(), "step": step})
    writer.write_sync(10, {"x": x + 10, "step": 10})
    writer.close()
    snap = reliability_metrics.snapshot()
    assert snap["checkpoint.write.p50"] >= 50.0, snap
    assert snap["checkpoint.submit.p99"] < snap["checkpoint.write.p50"] / 2
    assert snap["checkpoint.write.pending"] <= 1
    assert snap.get("checkpoint.write.coalesced", 0) >= 1
    payload = mgr.restore()
    assert payload["step"] == 10
    np.testing.assert_array_equal(payload["x"], x + 10)
    with pytest.raises(RuntimeError, match="closed"):
        writer.submit(11, {"step": 11})


def test_async_write_error_costs_one_step(tmp_path):
    """An injected error in a background write is absorbed and counted;
    later writes land; a failed synchronous write raises."""
    reliability_metrics.reset(prefix="checkpoint.")
    inj = FaultInjector(seed=3, rules=[
        {"site": "train.ckpt.write", "kind": "error", "at": [1, 3]}])
    mgr = CheckpointManager(str(tmp_path / "ck"))
    writer = AsyncCheckpointWriter(mgr, faults=inj)
    for step in (2, 4, 6):
        writer.submit(step, {"step": step})
        writer.flush()
    assert reliability_metrics.get("checkpoint.write.errors") == 1
    assert mgr.all_steps() == [2, 6]
    with pytest.raises(InjectedFault):
        writer.write_sync(8, {"step": 8})
    writer.write_sync(8, {"step": 8})
    writer.close()
    assert mgr.restore()["step"] == 8


def test_fault_schedule_is_seeded():
    """Two injectors of one seed fire the same faults on the same calls."""
    def run():
        inj = FaultInjector(seed=7, rules=[
            {"site": "train.*", "kind": "error", "prob": 0.3}])
        for _ in range(50):
            inj.fire("train.ckpt.write")
        return inj.schedule()
    assert run() == run() and 0 < len(run()) < 50
