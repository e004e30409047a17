"""Port parity: `ShardedLMTrainer.run_stream` (the prefetcher and the
supervised loop, `reliability.TrainingSupervisor`) on the CPU.

Following tests/test_supervisor.py (`:302-380`) and
tests/test_data_pipeline.py (`:413`): an unsupervised stream equals a
`step()` loop and the reference's `run_stream` (losses within 1e-6
relative); a run killed by an injected step crash and resumed in a fresh
trainer, and a crash absorbed in-run, end with losses and parameters equal
to the uninterrupted run's bit for bit; a corrupt newest checkpoint is
skipped; SIGTERM writes a final checkpoint and raises `Preempted`; and a
checkpoint directory that the reference's supervised `run_stream` wrote
resumes in the port, its continued losses within 1e-6 relative.
"""
import os
import signal
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.dnn.lm_training import \
    ShardedLMTrainer as JaxShardedLMTrainer
from mmlspark_tpu.parallel import grid_mesh
from mmlspark_tpu.reliability import FaultInjector as RefInjector
from mmlspark_tpu.reliability import RetryPolicy as RefRetryPolicy
from mmlspark_tpu_torch.models.dnn import ShardedLMTrainer
from mmlspark_tpu_torch.models.dnn.lm_training import (lm_state_from_payload,
                                                       lm_state_payload)
from mmlspark_tpu_torch.models.dnn.transformer import _flatten
from mmlspark_tpu_torch.reliability import (FaultInjector, MetricsRegistry,
                                            Preempted, RetryPolicy,
                                            StepTimeout, TrainingSupervisor)
from mmlspark_tpu_torch.telemetry import StepClock
from mmlspark_tpu_torch.utils.checkpoint import CheckpointManager

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

pytestmark = pytest.mark.chaos

_KW = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=1, d_ff=64,
           max_len=16, seed=0)


def _batches(n=8):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 64, size=(4, 16)).astype(np.int32)
            for _ in range(n)]


def _trainer(**kw):
    return ShardedLMTrainer(device="cpu", **{**_KW, **kw})


def _same_params(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(_flatten(a.params), _flatten(b.params)))


def _crash(step=5):
    return FaultInjector(seed=7, rules=[
        {"site": f"train.step{step}", "kind": "crash", "at": [0]}])


def test_run_stream_matches_stepwise_and_reference():
    batches = _batches(3)
    ref = _trainer()
    want = [ref.step(b) for b in batches]
    got = _trainer().run_stream(iter(batches), prefetch=2)
    assert got == want
    jax_t = JaxShardedLMTrainer(mesh=grid_mesh((1, 1)), **_KW)
    np.testing.assert_allclose(got, jax_t.run_stream(iter(batches)),
                               rtol=1e-6)
    # steps_per_batch chains updates on each batch as run() does
    chained = _trainer().run_stream(batches[:2], steps_per_batch=2)
    t = _trainer()
    assert chained == [t.run(batches[0], 2), t.run(batches[1], 2)]


def test_restored_state_leaves_the_payload_unchanged():
    """A payload restored and trained on stays as it was (the supervisor
    restores its in-memory snapshot once per restart): the optimizer's
    moments are copies, not views of the payload's arrays."""
    t = _trainer()
    t.step(_batches(1)[0])
    payload = lm_state_payload(t.params, t._opt, t.meta, t._blocks)
    saved = {k: np.array(v) for k, v in payload.items()
             if isinstance(v, np.ndarray)}
    losses = []
    for _ in range(2):
        lm_state_from_payload(payload, t.params, t._opt, t.meta, t._blocks)
        losses.append([t.step(b) for b in _batches(2)])
        for k, v in saved.items():
            assert np.array_equal(payload[k], v), k
    assert losses[0] == losses[1]


def test_supervisor_options_need_checkpoint_dir(tmp_path):
    """Supervisor options need checkpoint_dir; with it, the multi-process
    options are taken (a heartbeat beats at each mark and clears on the
    clean finish)."""
    from mmlspark_tpu_torch.parallel.cluster import Heartbeat
    with pytest.raises(TypeError, match="checkpoint_dir"):
        _trainer().run_stream(_batches(2), faults=_crash())
    hb = Heartbeat(str(tmp_path / "hb"), process_id=0)
    losses = _trainer().run_stream(
        _batches(2), checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
        heartbeat=hb)
    assert len(losses) == 2
    assert not os.path.exists(hb.path)


def test_kill_resume_bit_identity(tmp_path):
    """run_stream dies at an injected step crash (no retry left); a fresh
    trainer resumes from the newest checkpoint and ends with the
    uninterrupted run's losses and parameters, bit for bit."""
    batches = _batches()
    a = _trainer()
    ref = a.run_stream(batches)
    d = str(tmp_path / "ck")
    with pytest.raises(Exception, match="injected crash"):
        _trainer().run_stream(batches, checkpoint_dir=d, checkpoint_every=2,
                              faults=_crash(),
                              retry_policy=RetryPolicy(max_attempts=1))
    assert CheckpointManager(d).all_steps() == [2, 4]
    c = _trainer(seed=3)
    assert c.run_stream(batches, checkpoint_dir=d, checkpoint_every=2) == ref
    assert _same_params(a, c)


def test_in_run_crash_restart_bit_identity(tmp_path):
    """The same crash absorbed in-run by the retry policy: the step replays
    from the in-memory snapshot and the run ends bit-identical, its data
    wait and lost time on the clock."""
    batches = _batches()
    a = _trainer()
    ref = a.run_stream(batches)
    metrics = MetricsRegistry()
    clock = StepClock(registry=metrics)
    b = _trainer()
    out = b.run_stream(batches, checkpoint_dir=str(tmp_path / "ck"),
                       checkpoint_every=2, faults=_crash(), metrics=metrics,
                       step_clock=clock)
    assert out == ref and _same_params(a, b)
    assert metrics.get("train.step_restarts") == 1
    assert metrics.gauge("checkpoint.write.pending") <= 2
    snap = clock.snapshot()
    assert snap["steps"] == len(batches) + 1     # the replayed step
    assert snap["phases"]["lost_s"] > 0 and 0 < snap["goodput"] < 1


def test_corrupt_newest_checkpoint_is_skipped(tmp_path):
    """A torn newest step costs one interval, not the run: the resume
    falls back to the step before it and still ends bit-identical."""
    batches = _batches()
    a = _trainer()
    ref = a.run_stream(batches)
    d = str(tmp_path / "ck")
    with pytest.raises(Exception, match="injected crash"):
        _trainer().run_stream(batches, checkpoint_dir=d, checkpoint_every=2,
                              faults=_crash(7),
                              retry_policy=RetryPolicy(max_attempts=1))
    mgr = CheckpointManager(d)
    assert mgr.all_steps() == [2, 4, 6]
    FaultInjector(seed=3).corrupt_file(
        os.path.join(mgr._step_dir(6), "payload.npz"))
    c = _trainer()
    assert c.run_stream(batches, checkpoint_dir=d, checkpoint_every=2) == ref
    assert _same_params(a, c)


def test_preemption_writes_final_checkpoint_and_raises(tmp_path):
    """SIGTERM mid-run: the in-flight step finishes, a final synchronous
    checkpoint lands, Preempted is raised, and a resumed run continues
    from exactly there."""
    batches = _batches()
    a = _trainer()
    ref = a.run_stream(batches)
    d = str(tmp_path / "ck")
    b = _trainer()
    orig = b._update
    calls = []

    def update(tok):
        calls.append(1)
        if len(calls) == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(tok)

    b._update = update
    with pytest.raises(Preempted) as exc:
        b.run_stream(batches, checkpoint_dir=d, checkpoint_every=3)
    assert exc.value.step == 4 and exc.value.signum == signal.SIGTERM
    payload = CheckpointManager(d).restore()
    assert payload["sup_step"] == 4 and payload["sup_preempted"] is True
    np.testing.assert_array_equal(payload["sup_results"], ref[:4])
    c = _trainer()
    assert c.run_stream(batches, checkpoint_dir=d, checkpoint_every=3) == ref
    assert _same_params(a, c)


def test_exit_on_preempt_exits_zero_after_the_final_checkpoint(tmp_path):
    """ROADMAP Queue 3 (w): `run(exit_on_preempt=True)` ends with
    SystemExit(0) after the final checkpoint, and `preempted` says so."""
    from mmlspark_tpu_torch.reliability import TrainingSupervisor
    state = {"x": 0.0}
    sup = TrainingSupervisor(
        str(tmp_path / "ck"), lambda: {"x": state["x"]},
        lambda p: state.update(x=float(p["x"])), checkpoint_every=2,
        metrics=MetricsRegistry())
    assert sup.preempted is False

    def step(k):
        state["x"] += 1
        if k == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return state["x"]

    with pytest.raises(SystemExit) as exc:
        sup.run(step, 10, exit_on_preempt=True)
    sup.close()
    assert exc.value.code == 0 and sup.preempted is True
    payload = CheckpointManager(str(tmp_path / "ck")).restore()
    assert payload["sup_step"] == 3 and payload["sup_preempted"] is True


def test_step_timeout_restarts_the_step(tmp_path):
    """A step past its wall-clock budget raises StepTimeout inside the
    supervisor and replays from the snapshot."""
    state = {"x": 0.0, "slow": True}

    def step(k):
        if k == 1 and state["slow"]:
            # hangs past the budget; the abandoned attempt changes nothing
            state["slow"] = False
            time.sleep(0.2)
            return None
        state["x"] += k + 1
        return state["x"]

    metrics = MetricsRegistry()
    sup = TrainingSupervisor(
        str(tmp_path), lambda: {"x": np.float64(state["x"])},
        lambda p: state.update(x=float(p["x"])), checkpoint_every=1,
        step_timeout=0.05, metrics=metrics)
    assert StepTimeout in sup.restart_on
    out = sup.run(step, 3)
    sup.close()
    assert out == [1.0, 3.0, 6.0]
    assert metrics.get("train.step_timeouts") == 1
    assert metrics.get("train.step_restarts") == 1


def test_reference_run_stream_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's supervised run_stream dies at an injected crash
    with checkpoints 2 and 4 on disk; the port resumes that directory (its
    loss history and goodput clock included) and its continued losses
    equal the reference's uninterrupted run within 1e-6 relative."""
    batches = _batches()
    want = JaxShardedLMTrainer(mesh=grid_mesh((1, 1)), **_KW).run_stream(
        batches)
    d = str(tmp_path / "ck")
    inj = RefInjector(seed=7, rules=[
        {"site": "train.step5", "kind": "crash", "at": [0]}])
    with pytest.raises(Exception, match="injected crash"):
        JaxShardedLMTrainer(mesh=grid_mesh((1, 1)), **_KW).run_stream(
            batches, checkpoint_dir=d, checkpoint_every=2, faults=inj,
            retry_policy=RefRetryPolicy(max_attempts=1))
    clock = StepClock(registry=MetricsRegistry())
    got = _trainer(seed=5).run_stream(batches, checkpoint_dir=d,
                                      checkpoint_every=2, step_clock=clock)
    assert got[:4] == want[:4]       # the reference's history, restored
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert clock.snapshot()["steps"] >= len(batches)
