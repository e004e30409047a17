"""Port parity: pipeline and tensor parallelism in LM training
(`mmlspark_tpu_torch.models.dnn.PipelinedLMTrainer` over a mesh's pipe
and model axes, `ShardedLMTrainer` over a data x model mesh).

The JAX trainers run their programs on meshes of the 8-device virtual CPU
mesh of conftest.py (GPipe stages, Megatron slices, ring attention, the
flash kernels in interpret mode); the port runs the same shapes from one
process over `grid_mesh(shape, ..., devices=["cpu"] * n)` (the plain
versions). Both start from `init_transformer(seed=0)` (vocab 64, d_model
32, 4 heads, 4 layers, d_ff 64) and take the same seeded tokens (8, 32).
Tolerances, those of tests/test_torch_lm_training{,_cp}.py:
- SGD at lr 1 (the weight deltas are the gradients, which Adam would hide
  under its scale invariance): losses within 1e-5 and the deltas within
  1e-4 of each leaf's max |delta| (f32 sums in other orders);
- Adam trajectories within 1e-5; bf16 losses within 1e-3;
- a restored trainer continues within rtol 1e-6 on the mesh that saved,
  within the parity tolerance on another mesh or in the other package;
- ShardedLMTrainer against mesh=None at the reference's own tolerance,
  rtol 2e-4 and atol 2e-5 (tests/test_lm_training.py).
"""
import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.dnn.lm_training import \
    ShardedLMTrainer as JaxShardedLMTrainer
from mmlspark_tpu.models.dnn.pp_training import \
    PipelinedLMTrainer as JaxPipelinedLMTrainer
from mmlspark_tpu.parallel import grid_mesh as jax_grid_mesh
from mmlspark_tpu_torch.models.dnn import (PipelinedLMTrainer,
                                           ShardedLMTrainer,
                                           params_to_numpy)
from mmlspark_tpu_torch.models.dnn.lm_training import lm_state_payload
from mmlspark_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS,
                                         SEQ_AXIS, grid_mesh)

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_AXES = (DATA_AXIS, PIPE_AXIS, MODEL_AXIS, SEQ_AXIS)
_MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
              max_len=32)
_SGD = dict(_MODEL, seed=0, optimizer="sgd", lr=1.0)


def _tokens():
    return np.random.default_rng(0).integers(0, 64, size=(8, 32)).astype(
        np.int32)


def _cpu_mesh(shape, axes=_AXES):
    return grid_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flat(tree[key], f"{prefix}/{key}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _port_flat(t):
    return dict(_flat(params_to_numpy(t.params)))


def _jax_flat(t):
    return dict(_flat(jax.tree_util.tree_map(np.asarray, t.params)))


def _assert_deltas(start, got, want, rel=1e-4):
    """Per leaf, max |delta_got - delta_want| <= rel * max |delta_want|."""
    assert got.keys() == want.keys() == start.keys()
    for name, a in start.items():
        d_got, d_want = got[name] - a, want[name] - a
        err = float(np.abs(d_got - d_want).max())
        assert err <= rel * float(np.abs(d_want).max()), (name, err)


@pytest.mark.parametrize("shape,attention,m", [
    ((2, 2, 1, 1), "dense", 2), ((1, 4, 1, 1), "dense", 4),
    ((1, 4, 1, 1), "dense", 8), ((1, 1, 2, 1), "dense", 2),
    ((2, 2, 2, 1), "dense", 2), ((1, 2, 2, 2), "dense", 2),
    ((1, 2, 2, 1), "flash", 2), ((1, 2, 2, 2), "flash", 2)])
def test_sgd_steps_match_jax(shape, attention, m):
    """Two SGD steps on a pipe and/or model mesh against the JAX trainer
    on the same mesh: the losses, and the weight deltas leaf by leaf."""
    toks = _tokens()
    jax_t = JaxPipelinedLMTrainer(mesh=jax_grid_mesh(shape, _AXES),
                                  n_microbatches=m, attention=attention,
                                  **_SGD)
    port = PipelinedLMTrainer(mesh=_cpu_mesh(shape), n_microbatches=m,
                              attention=attention, **_SGD)
    start = _port_flat(port)
    want = [jax_t.step(toks) for _ in range(2)]
    got = [port.step(toks), port.run(toks, 1)]
    assert got == pytest.approx(want, abs=1e-5)
    assert got[1] < got[0]
    _assert_deltas(start, _port_flat(port), _jax_flat(jax_t))


def test_sgd_parity_across_pp_and_tp():
    """Inside the port, from one init: SGD at pipe 1 / 2 / 4 and model
    1 / 2 lands on the weights of the one-position trainer. A gradient
    counted pp or tp times (a stage's embed, a replicated norm) would be
    off by a whole multiple."""
    toks = _tokens()
    one = PipelinedLMTrainer(n_microbatches=2, device="cpu", **_SGD)
    start = _port_flat(one)
    want_losses = [one.step(toks) for _ in range(2)]
    want = _port_flat(one)
    for pp in (1, 2, 4):
        for tp in (1, 2):
            t = PipelinedLMTrainer(mesh=_cpu_mesh((1, pp, tp, 1)),
                                   n_microbatches=2, **_SGD)
            got = [t.step(toks) for _ in range(2)]
            assert got == pytest.approx(want_losses, abs=1e-5), (pp, tp)
            _assert_deltas(start, _port_flat(t), want)


def test_masters_are_stage_and_tensor_sharded():
    """Each (pipe, model) position holds its L/P layers' Megatron blocks:
    wq/wk/wv/w1/b1 cut on their outputs, wo/w2 on their inputs, the
    norms and b2 once per stage at model 0; `params` reads the full
    (L, ...) leaves, equal to the unsharded trainer's."""
    t = PipelinedLMTrainer(mesh=_cpu_mesh((2, 2, 2, 1)), n_microbatches=2,
                           **_SGD)
    for s in range(2):
        for j in range(2):
            p = t.position_params(pipe=s, model=j)
            shapes = {k: tuple(v.shape) for k, v in p.items()
                      if not isinstance(v, dict)}
            want = {"wq": (2, 32, 16), "wk": (2, 32, 16),
                    "wv": (2, 32, 16), "wo": (2, 16, 32),
                    "w1": (2, 32, 32), "b1": (2, 32), "w2": (2, 32, 32)}
            if j == 0:
                want["b2"] = (2, 32)
                assert tuple(p["ln1"]["scale"].shape) == (2, 32)
                assert tuple(p["ln2"]["bias"].shape) == (2, 32)
            else:
                assert "ln1" not in p and "ln2" not in p
            assert shapes == want, (s, j)
    full = _port_flat(t)
    one = _port_flat(PipelinedLMTrainer(n_microbatches=2, device="cpu",
                                        **_SGD))
    assert full.keys() == one.keys()
    assert all(np.array_equal(full[k], one[k]) for k in one)
    assert full["/layers/wq"].shape == (4, 32, 32)
    # every master is a leaf of the optimizer: 16 leaves, 4 positions,
    # 7 cut leaves x 4 + 5 replicated x 2 stages + 4 shared
    assert len(t._opt.param_groups[0]["params"]) == 7 * 4 + 5 * 2 + 4


def test_bf16_save_attn_flash_matches_one_position():
    """bf16 compute with f32 masters, remat="save_attn", flash, Adam, on
    a pipe x model mesh against the one-position trainer: losses within
    the bf16 tolerance; the masters stay f32."""
    toks = _tokens()
    kw = dict(_MODEL, seed=0, n_microbatches=2, attention="flash",
              compute_dtype="bfloat16", remat="save_attn")
    losses = {}
    for shape in ((1, 1, 1, 1), (1, 2, 2, 1)):
        t = PipelinedLMTrainer(mesh=_cpu_mesh(shape), **kw)
        losses[shape] = [t.step(toks) for _ in range(3)]
    assert losses[(1, 2, 2, 1)] == pytest.approx(losses[(1, 1, 1, 1)],
                                                  abs=1e-3)
    assert losses[(1, 2, 2, 1)][-1] < losses[(1, 2, 2, 1)][0]
    assert all(a.dtype == np.float32 for a in _port_flat(t).values())


@pytest.mark.parametrize("remat", ["full", "save_attn"])
def test_remat_on_pipe_and_model_axes(remat):
    """remat recomputes each position's blocks with its own masters: the
    same losses as no remat, to 1e-6."""
    toks = _tokens()
    losses = {}
    for r in (False, remat):
        t = PipelinedLMTrainer(mesh=_cpu_mesh((1, 2, 2, 2)),
                               n_microbatches=2, attention="flash",
                               remat=r, **_SGD)
        losses[r] = [t.step(toks) for _ in range(2)]
    assert losses[remat] == pytest.approx(losses[False], abs=1e-6)


def _adam_pp(shape, seed=0, **kw):
    return PipelinedLMTrainer(mesh=_cpu_mesh(shape), n_microbatches=2,
                              seed=seed, **{**_MODEL, **kw})


def test_checkpoint_on_the_3d_mesh(tmp_path):
    """Save on (2, 2, 2, 1) after two Adam steps: a seed-99 trainer on the
    same mesh continues within rtol 1e-6; the one-position trainer and
    the JAX trainer on grid_mesh((2, 2, 2)) continue within the parity
    tolerance; and the one-position trainer's own save restores into the
    3D mesh. The payload is the reference's (L, ...) layout."""
    toks = _tokens()
    t = _adam_pp((2, 2, 2, 1))
    t.step(toks)
    t.step(toks)
    t.save_checkpoint(str(tmp_path / "3d"), step=2)
    want = [t.step(toks) for _ in range(2)]

    again = _adam_pp((2, 2, 2, 1), seed=99)
    again.step(toks)
    assert again.restore_checkpoint(str(tmp_path / "3d")) == 2
    np.testing.assert_allclose([again.step(toks) for _ in range(2)], want,
                               rtol=1e-6)

    one = PipelinedLMTrainer(n_microbatches=2, device="cpu", seed=7,
                             **_MODEL)
    assert one.restore_checkpoint(str(tmp_path / "3d")) == 2
    assert [one.step(toks) for _ in range(2)] == pytest.approx(want,
                                                               abs=1e-5)
    ref = JaxPipelinedLMTrainer(
        mesh=jax_grid_mesh((2, 2, 2), _AXES[:3]), n_microbatches=2, seed=7,
        **_MODEL)
    assert ref.restore_checkpoint(str(tmp_path / "3d")) == 2
    assert [ref.step(toks) for _ in range(2)] == pytest.approx(want,
                                                               abs=1e-5)

    # and back: the one-position trainer's checkpoint into the 3D mesh
    one.save_checkpoint(str(tmp_path / "one"), step=4)
    one_next = [one.step(toks) for _ in range(2)]
    back = _adam_pp((2, 2, 2, 1), seed=5)
    assert back.restore_checkpoint(str(tmp_path / "one")) == 4
    assert [back.step(toks) for _ in range(2)] == pytest.approx(one_next,
                                                                abs=1e-5)

    # the payloads of the two layouts agree leaf for leaf, Adam's too
    a = lm_state_payload(back.params, back._opt, back.meta, back._blocks)
    b = lm_state_payload(one.params, one._opt, one.meta)
    assert set(a) == set(b) and a["treedef_p"] == b["treedef_p"]
    for k in a:
        if k.startswith(("p_", "o_")):
            assert np.shape(a[k]) == np.shape(b[k]), k
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3, atol=1e-5,
                                       err_msg=k)


def test_checkpoint_refusals(tmp_path):
    t = _adam_pp((2, 2, 2, 1))
    t.step(_tokens())
    t.save_checkpoint(str(tmp_path), step=1)
    with pytest.raises(ValueError, match="different model"):
        _adam_pp((2, 2, 2, 1), d_model=64).restore_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="parameter leaves"):
        ShardedLMTrainer(mesh=_cpu_mesh((2, 2), (DATA_AXIS, MODEL_AXIS)),
                         **_MODEL).restore_checkpoint(str(tmp_path))


@pytest.mark.parametrize("shape", [(2, 4), (2, 2)])
def test_sharded_trainer_on_a_mesh(shape):
    """ShardedLMTrainer on a data x model mesh: three Adam steps against
    the JAX trainer on the same mesh within 1e-5, and against mesh=None
    at the reference's tolerance; the masters are Megatron blocks."""
    toks = _tokens()
    jax_t = JaxShardedLMTrainer(mesh=jax_grid_mesh(shape), seed=0,
                                **_MODEL)
    port = ShardedLMTrainer(mesh=_cpu_mesh(shape, (DATA_AXIS, MODEL_AXIS)),
                            seed=0, **_MODEL)
    alone = ShardedLMTrainer(device="cpu", seed=0, **_MODEL)
    want = [jax_t.step(toks) for _ in range(3)]
    got = [port.step(toks)] + [port.run(toks, 1) for _ in range(2)]
    assert got == pytest.approx(want, abs=1e-5)
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, [alone.step(toks) for _ in range(3)],
                               rtol=2e-4, atol=2e-5)
    tp = shape[1]
    for j in range(tp):
        layer = port.position_params(model=j)[0]
        assert tuple(layer["wq"].shape) == (32, 32 // tp)
        assert tuple(layer["wo"].shape) == (32 // tp, 32)
        assert tuple(layer["b1"].shape) == (64 // tp,)
        assert ("ln1" in layer) == (j == 0)


def test_validation_errors():
    with pytest.raises(ValueError, match="must divide by the pipe axis"):
        PipelinedLMTrainer(mesh=_cpu_mesh((1, 3, 1, 1)), **_SGD)
    with pytest.raises(ValueError, match="n_heads .* must divide by the "
                                         "model axis"):
        PipelinedLMTrainer(mesh=_cpu_mesh((1, 1, 3, 1)), **_SGD)
    with pytest.raises(ValueError, match="d_ff .* must divide by the "
                                         "model axis"):
        PipelinedLMTrainer(mesh=_cpu_mesh((1, 1, 4, 1)),
                           **{**_SGD, "d_ff": 66})
    with pytest.raises(ValueError, match="'pipe' axis"):
        PipelinedLMTrainer(mesh=_cpu_mesh((1, 2), (DATA_AXIS, MODEL_AXIS)),
                           **_SGD)
    with pytest.raises(ValueError, match="dp\\*microbatches = 8"):
        PipelinedLMTrainer(mesh=_cpu_mesh((2, 2, 1, 1)), n_microbatches=4,
                           **_SGD).step(_tokens()[:4])
    sharded = dict(_MODEL, seed=0)
    with pytest.raises(ValueError, match="'data' and 'model' axes"):
        ShardedLMTrainer(mesh=_cpu_mesh((2,), (DATA_AXIS,)), **sharded)
    with pytest.raises(ValueError, match="n_heads .* model axis"):
        ShardedLMTrainer(mesh=_cpu_mesh((1, 3), (DATA_AXIS, MODEL_AXIS)),
                         **sharded)
    with pytest.raises(ValueError, match="d_ff .* model axis"):
        ShardedLMTrainer(mesh=_cpu_mesh((1, 4), (DATA_AXIS, MODEL_AXIS)),
                         **{**sharded, "d_ff": 66})
    with pytest.raises(ValueError, match="first device"):
        ShardedLMTrainer(mesh=_cpu_mesh((1, 2), (DATA_AXIS, MODEL_AXIS)),
                         device="meta", **sharded)
    with pytest.raises(ValueError, match="data axis \\(2\\)"):
        ShardedLMTrainer(mesh=_cpu_mesh((2, 1), (DATA_AXIS, MODEL_AXIS)),
                         **sharded).step(_tokens()[:3])
    # run_stream is ported (slice 15): over the mesh, a one-batch stream
    # is one step
    assert ShardedLMTrainer(
        mesh=_cpu_mesh((2, 2), (DATA_AXIS, MODEL_AXIS)),
        **sharded).run_stream([_tokens()]) == [ShardedLMTrainer(
            mesh=_cpu_mesh((2, 2), (DATA_AXIS, MODEL_AXIS)),
            **sharded).step(_tokens())]
    mesh = _cpu_mesh((1, 2, 2, 1))
    assert mesh.device_at(pipe=1, model=1) == torch.device("cpu")
    with pytest.raises(ValueError, match="no 'expert' axis"):
        mesh.device_at(expert=1)
