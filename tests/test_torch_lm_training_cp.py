"""Port parity: context-parallel LM training
(`mmlspark_tpu_torch.models.dnn.PipelinedLMTrainer` over a mesh's data
and seq axes).

The JAX trainer runs its 4D program on meshes of the 8-device virtual
CPU mesh of conftest.py (`grid_mesh(shape, (data, pipe, model, seq))`,
ring attention across the seq shards, the flash stats kernels in
interpret mode); the port runs the same shapes from one process over
`grid_mesh(shape, ..., devices=["cpu"] * n)` (the plain versions). Both
start from `init_transformer(seed=0)` (vocab 64, d_model 32, 2 heads,
2 layers, d_ff 64) and take the same seeded tokens (4, 32) in 2
microbatches, SGD at lr 1, so the weight deltas are the gradients.
Tolerances, those of tests/test_torch_lm_training.py:
- losses within 1e-5 (f32, sums in other orders);
- weight deltas within 1e-4 of each leaf's max |delta|.
"""
import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.dnn.pp_training import \
    PipelinedLMTrainer as JaxPipelinedLMTrainer
from mmlspark_tpu.parallel import grid_mesh as jax_grid_mesh
from mmlspark_tpu_torch.models.dnn import (PipelinedLMTrainer,
                                           ShardedLMTrainer,
                                           params_to_numpy)
from mmlspark_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS,
                                         SEQ_AXIS, grid_mesh)

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_AXES = (DATA_AXIS, PIPE_AXIS, MODEL_AXIS, SEQ_AXIS)
_KW = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_len=32, seed=0, n_microbatches=2, optimizer="sgd", lr=1.0)


def _tokens():
    return np.random.default_rng(0).integers(0, 64, size=(4, 32)).astype(
        np.int32)


def _cpu_mesh(shape):
    return grid_mesh(shape, _AXES, devices=["cpu"] * int(np.prod(shape)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flat(tree[key], f"{prefix}/{key}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("shape", [(1, 1, 1, 2), (2, 1, 1, 2),
                                   (1, 1, 1, 4)])
@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_cp_sgd_steps_match_jax(shape, attention):
    toks = _tokens()
    jax_t = JaxPipelinedLMTrainer(mesh=jax_grid_mesh(shape, _AXES),
                                  attention=attention, **_KW)
    port = PipelinedLMTrainer(mesh=_cpu_mesh(shape), attention=attention,
                              **_KW)
    start = dict(_flat(params_to_numpy(port.params)))
    want = [jax_t.step(toks) for _ in range(2)]
    got = [port.step(toks), port.run(toks, 1)]
    assert got == pytest.approx(want, abs=1e-5)
    assert got[1] < got[0]
    now = dict(_flat(params_to_numpy(port.params)))
    jax_now = dict(_flat(jax.tree_util.tree_map(np.asarray, jax_t.params)))
    assert now.keys() == jax_now.keys() == start.keys()
    for name, a in start.items():
        d_port, d_jax = now[name] - a, jax_now[name] - a
        err = float(np.abs(d_port - d_jax).max())
        assert err <= 1e-4 * float(np.abs(d_jax).max()), (name, err)


def test_cp_remat_and_bf16_match_cp1():
    """The ring trainer's remat modes recompute the same ops, and in bf16
    its losses stay within the bf16 tolerance of the trainer without a
    seq axis (tests/test_torch_lm_training.py: 1e-3)."""
    toks = _tokens()
    losses = {}
    for remat in (False, "full", "save_attn"):
        t = PipelinedLMTrainer(mesh=_cpu_mesh((2, 1, 1, 2)),
                               attention="flash", remat=remat, **_KW)
        losses[remat] = [t.step(toks) for _ in range(2)]
    assert losses["full"] == pytest.approx(losses[False], abs=1e-6)
    assert losses["save_attn"] == pytest.approx(losses[False], abs=1e-6)
    bf16 = {}
    for shape in ((1, 1, 1, 1), (1, 1, 1, 4)):
        t = PipelinedLMTrainer(mesh=_cpu_mesh(shape), attention="flash",
                               compute_dtype="bfloat16", remat="save_attn",
                               **_KW)
        bf16[shape] = [t.step(toks) for _ in range(2)]
    assert bf16[(1, 1, 1, 4)] == pytest.approx(bf16[(1, 1, 1, 1)], abs=1e-3)


def test_mesh_errors_are_kept():
    with pytest.raises(ValueError, match="seq axis"):
        PipelinedLMTrainer(mesh=_cpu_mesh((1, 1, 1, 4)), **_KW).step(
            _tokens()[:, :30])
    with pytest.raises(ValueError, match="dp\\*microbatches = 4"):
        PipelinedLMTrainer(mesh=_cpu_mesh((2, 1, 1, 2)), **_KW).step(
            _tokens()[:2])
    # n_layers 2 over a pipe of 4; n_heads 2 and d_ff 64 over a model
    # axis of 3 (the reference's words)
    with pytest.raises(ValueError, match="must divide by the pipe axis"):
        PipelinedLMTrainer(mesh=_cpu_mesh((1, 4, 1, 1)), **_KW)
    with pytest.raises(ValueError, match="n_heads .* must divide by the "
                                         "model axis"):
        PipelinedLMTrainer(mesh=_cpu_mesh((1, 1, 3, 1)), **_KW)
    with pytest.raises(ValueError, match="d_ff .* must divide by the "
                                         "model axis"):
        PipelinedLMTrainer(mesh=_cpu_mesh((1, 1, 2, 1)),
                           **{**_KW, "d_ff": 63})
    with pytest.raises(ValueError, match="'pipe' axis"):
        PipelinedLMTrainer(mesh=grid_mesh((1, 2), (DATA_AXIS, SEQ_AXIS),
                                          devices=["cpu"] * 2), **_KW)
    with pytest.raises(ValueError, match="first device"):
        PipelinedLMTrainer(mesh=_cpu_mesh((1, 1, 1, 2)), device="meta",
                           **_KW)
    with pytest.raises(ValueError, match="n_heads .* model axis"):
        ShardedLMTrainer(mesh=_cpu_mesh((1, 1, 3, 1)), vocab_size=64,
                         d_model=32, n_heads=2, device="cpu")
