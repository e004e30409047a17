"""Port parity: the LM trainers' checkpoints (`save_checkpoint`,
`restore_checkpoint`, `lm_state_payload`, `lm_state_from_payload`), on the
CPU.

A differently seeded trainer restored from step k continues the saved
trajectory at the reference's tolerance, rtol 1e-6
(tests/test_lm_training.py, tests/test_pp_training.py); a checkpoint
written by either package restores in the other (the same payload: the
params by their treedef, the optimizer in `optax.adam`'s flatten order),
and the next losses agree at the trainers' parity tolerance
(tests/test_torch_lm_training.py). A foreign config or layout is refused
in the reference's words.
"""
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.dnn.lm_training import \
    ShardedLMTrainer as JaxShardedLMTrainer
from mmlspark_tpu.models.dnn.pp_training import \
    PipelinedLMTrainer as JaxPipelinedLMTrainer
from mmlspark_tpu.parallel import DATA_AXIS, PIPE_AXIS, grid_mesh
from mmlspark_tpu_torch.models.dnn import PipelinedLMTrainer, ShardedLMTrainer
from mmlspark_tpu_torch.models.dnn.lm_training import lm_state_payload
from mmlspark_tpu_torch.models.dnn.payload import (tree_from_payload,
                                                   tree_to_payload)
from mmlspark_tpu_torch.models.dnn.transformer import _flatten

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_KW = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_len=32, seed=0)


def _tokens():
    return np.random.default_rng(0).integers(0, 64, size=(4, 32)).astype(
        np.int32)


def _port(kind, **kw):
    if kind == "pipelined":
        return PipelinedLMTrainer(n_microbatches=2, device="cpu",
                                  **{**_KW, **kw})
    return ShardedLMTrainer(device="cpu", **{**_KW, **kw})


def _jax(kind, **kw):
    if kind == "pipelined":
        return JaxPipelinedLMTrainer(
            mesh=grid_mesh((1, 1), (DATA_AXIS, PIPE_AXIS)),
            n_microbatches=2, **{**_KW, **kw})
    return JaxShardedLMTrainer(mesh=grid_mesh((1, 1)), **{**_KW, **kw})


@pytest.mark.parametrize("kind", ["pipelined", "sharded"])
def test_restore_continues_exactly(tmp_path, kind):
    """Save at step 2; a trainer of another seed (one that has stepped,
    and one that never has) restores and its next two losses equal the
    uninterrupted run's at rtol 1e-6; its parameters equal the saved
    ones."""
    toks = _tokens()
    t = _port(kind)
    t.step(toks)
    t.step(toks)
    t.save_checkpoint(str(tmp_path), step=2)
    saved = [a.detach().clone() for a in _flatten(t.params)]
    want = [t.step(toks) for _ in range(2)]
    for stepped in (True, False):
        t2 = _port(kind, seed=99)
        if stepped:
            t2.step(toks)
        assert t2.restore_checkpoint(str(tmp_path)) == 2
        assert all(torch.equal(a, b)
                   for a, b in zip(_flatten(t2.params), saved))
        got = [t2.step(toks) for _ in range(2)]
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("kind", ["pipelined", "sharded"])
def test_checkpoints_cross_packages(tmp_path, kind):
    """The reference's checkpoint restores in the port and the port's in
    the reference: after a restore, each package's next two losses match
    the writer's own continuation (abs 1e-5, the trainers' parity
    tolerance)."""
    toks = _tokens()
    ref = _jax(kind)
    ref.step(toks)
    ref.save_checkpoint(str(tmp_path / "ref"), step=1)
    ref_next = [ref.step(toks) for _ in range(2)]
    port = _port(kind, seed=7)
    assert port.restore_checkpoint(str(tmp_path / "ref")) == 1
    assert [port.step(toks) for _ in range(2)] == pytest.approx(ref_next,
                                                                abs=1e-5)

    port = _port(kind)
    port.step(toks)
    port.save_checkpoint(str(tmp_path / "port"), step=1)
    port_next = [port.step(toks) for _ in range(2)]
    ref = _jax(kind, seed=7)
    assert ref.restore_checkpoint(str(tmp_path / "port")) == 1
    assert [ref.step(toks) for _ in range(2)] == pytest.approx(port_next,
                                                               abs=1e-5)


def test_payload_layout_is_the_references(tmp_path):
    """The port's payload has the reference's keys, treedef and leaf
    shapes and dtypes (the Adam count an int32 scalar), key for key."""
    from mmlspark_tpu.models.dnn.lm_training import \
        lm_state_payload as ref_payload
    toks = _tokens()
    port, ref = _port("pipelined"), _jax("pipelined")
    port.step(toks)
    ref.step(toks)
    got = lm_state_payload(port.params, port._opt, port.meta)
    want = ref_payload(ref.params, ref.opt_state, ref.meta)
    assert set(got) == set(want)
    assert got["treedef_p"] == want["treedef_p"]
    assert got["meta"] == dict(want["meta"])
    for k, v in want.items():
        if k.startswith(("p_", "o_")):
            assert got[k].shape == np.shape(v), k
            assert got[k].dtype == np.asarray(v).dtype, k
    assert int(got["o_0"]) == int(want["o_0"]) == 1


def test_tree_payload_round_trip():
    """tree_to_payload / tree_from_payload keep dicts (sorted) and lists."""
    tree = {"b": [np.arange(3), {"z": np.ones(2), "a": np.zeros(1)}],
            "a": np.full(2, 5.0)}
    back = tree_from_payload(tree_to_payload(tree, "p"), "p")
    assert list(back) == ["a", "b"] and list(back["b"][1]) == ["a", "z"]
    np.testing.assert_array_equal(back["b"][0], np.arange(3))
    np.testing.assert_array_equal(back["a"], np.full(2, 5.0))


def test_refusals(tmp_path):
    """Another model config is "different model"; another trainer's layout
    is "parameter leaves"; another optimizer is "optimizer leaves"."""
    toks = _tokens()
    t = _port("pipelined")
    t.step(toks)
    t.save_checkpoint(str(tmp_path / "pp"), step=1)
    with pytest.raises(ValueError, match="different model"):
        _port("pipelined", d_model=64).restore_checkpoint(
            str(tmp_path / "pp"))
    with pytest.raises(ValueError, match="parameter leaves"):
        _port("sharded").restore_checkpoint(str(tmp_path / "pp"))
    with pytest.raises(ValueError, match="parameter leaf 0 has shape"):
        _port("pipelined", vocab_size=96).restore_checkpoint(
            str(tmp_path / "pp"))
    with pytest.raises(ValueError, match="optimizer leaves"):
        _port("pipelined", optimizer="sgd").restore_checkpoint(
            str(tmp_path / "pp"))
