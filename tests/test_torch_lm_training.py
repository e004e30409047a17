"""Port parity: causal LM training on one device
(`mmlspark_tpu_torch.models.dnn.pp_training.PipelinedLMTrainer`,
`mmlspark_tpu_torch.models.dnn.lm_training.ShardedLMTrainer`).

The JAX trainers on a 1x1 mesh (JAX on the CPU, its flash kernels in
interpret mode) against the port's with device="cpu" (the plain flash
versions), both from `init_transformer(seed=0)` and the same seeded
tokens: vocab 64, d_model 32, 2 heads, 2 layers, d_ff 64, tokens (4, 32),
2 microbatches. Tolerances:
- SGD (lr 1) weight deltas, i.e. the gradients, within 1e-4 of each
  leaf's max |delta| (measured <= 3.4e-5: f32 sums in other orders; the
  layer-norm scales sum products over every position);
- f32 losses within 1e-5 (measured <= 1e-6);
- bf16 losses within 1e-3 (measured <= 1.8e-4): every matmul output and
  elementwise op rounds to bf16, and the two frameworks round the GELU and
  the adds at other points on the CPU;
- remat modes: the same ops recomputed, so the same losses to 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.dnn.lm_training import \
    ShardedLMTrainer as JaxShardedLMTrainer
from mmlspark_tpu.models.dnn.pp_training import \
    PipelinedLMTrainer as JaxPipelinedLMTrainer
from mmlspark_tpu.parallel import DATA_AXIS, PIPE_AXIS, grid_mesh
from mmlspark_tpu_torch.models.dnn import (PipelinedLMTrainer,
                                           ShardedLMTrainer,
                                           init_transformer,
                                           params_from_numpy,
                                           params_to_numpy,
                                           transformer_apply)
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.parallel import MODEL_AXIS
from mmlspark_tpu_torch.parallel import grid_mesh as port_grid_mesh

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_KW = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
           max_len=32, seed=0)


def _tokens():
    return np.random.default_rng(0).integers(0, 64, size=(4, 32)).astype(
        np.int32)


def _jax_pp(**kw):
    return JaxPipelinedLMTrainer(mesh=grid_mesh((1, 1), (DATA_AXIS,
                                                         PIPE_AXIS)),
                                 n_microbatches=2, **_KW, **kw)


def _port_pp(**kw):
    return PipelinedLMTrainer(n_microbatches=2, device="cpu", **_KW, **kw)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flat(tree[key], f"{prefix}/{key}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_sgd_step_matches_jax(attention):
    """One SGD step at lr 1 from the same weights: the weight deltas are
    the gradients, held leaf by leaf. The starting weights agree bit for
    bit, and the stacked tree converts both ways."""
    jax_t = _jax_pp(attention=attention, optimizer="sgd", lr=1.0)
    port = _port_pp(attention=attention, optimizer="sgd", lr=1.0)
    start = dict(_flat(params_to_numpy(port.params)))
    jax_start = dict(_flat(jax.tree_util.tree_map(np.asarray,
                                                  jax_t.params)))
    assert start.keys() == jax_start.keys() and len(start) == 16
    for name, a in start.items():
        assert np.array_equal(a, jax_start[name]), name
    back = dict(_flat(params_to_numpy(params_from_numpy(jax_t.params,
                                                        "cpu"))))
    assert all(np.array_equal(back[n], a) for n, a in start.items())

    toks = _tokens()
    assert port.step(toks) == pytest.approx(jax_t.step(toks), abs=1e-5)
    got = dict(_flat(params_to_numpy(port.params)))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, jax_t.params)))
    for name, a in start.items():
        d_port, d_jax = got[name] - a, want[name] - a
        err = float(np.abs(d_port - d_jax).max())
        assert err <= 1e-4 * float(np.abs(d_jax).max()), (name, err)


def test_adam_trajectory_matches_jax():
    toks = _tokens()
    jax_t = _jax_pp(attention="flash")
    port = _port_pp(attention="flash")
    want = [jax_t.step(toks) for _ in range(3)]
    got = [port.step(toks) for _ in range(3)]
    assert got == pytest.approx(want, abs=1e-5)
    assert got[-1] < got[0]


def test_bf16_flash_save_attn_matches_jax():
    """The flagship bench's stack at a small size: bf16 compute with f32
    masters, remat="save_attn", flash attention, Adam."""
    toks = _tokens()
    kw = dict(attention="flash", compute_dtype="bfloat16",
              remat="save_attn")
    jax_t, port = _jax_pp(**kw), _port_pp(**kw)
    want = [jax_t.step(toks) for _ in range(3)]
    got = [port.step(toks) for _ in range(3)]
    assert got == pytest.approx(want, abs=1e-3)
    assert got[-1] < got[0]
    # the master weights stay f32
    assert all(a.dtype == np.float32
               for _, a in _flat(params_to_numpy(port.params)))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_remat_is_loss_invariant(compute_dtype, monkeypatch):
    """remat recomputes the same ops, so the Adam trajectory is the same;
    "full" runs the flash forward twice per layer and sequence, once in
    the forward and once in the backward's recompute, "save_attn" once."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa._flash_forward_lse_plain, fa._flash_backward_plain

    def count_fwd(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def count_bwd(*a):
        calls["bwd"] += 1
        return bwd(*a)
    monkeypatch.setattr(fa, "_flash_forward_lse_plain", count_fwd)
    monkeypatch.setattr(fa, "_flash_backward_plain", count_bwd)
    toks = _tokens()
    losses, per_step = {}, {}
    for remat in (False, "full", "save_attn"):
        t = _port_pp(attention="flash", compute_dtype=compute_dtype,
                     remat=remat)
        calls.update(fwd=0, bwd=0)
        first = t.step(toks)
        per_step[remat] = dict(calls)
        losses[remat] = [first] + [t.step(toks) for _ in range(2)]
    assert losses["full"] == pytest.approx(losses[False], abs=1e-6)
    assert losses["save_attn"] == pytest.approx(losses[False], abs=1e-6)
    # 2 layers x 4 sequences (2 microbatches of 2)
    assert per_step[False] == per_step["save_attn"] == {"fwd": 8, "bwd": 8}
    assert per_step["full"] == {"fwd": 16, "bwd": 8}


def test_sharded_trainer_matches_jax_and_pipelined():
    """The reference's oracle: ShardedLMTrainer (dense, Adam) against the
    JAX one on a 1x1 mesh, and the port's pipelined trainer against it
    (one schedule of the same math)."""
    toks = _tokens()
    jax_t = JaxShardedLMTrainer(mesh=grid_mesh((1, 1)), **_KW)
    port = ShardedLMTrainer(device="cpu", **_KW)
    want = [jax_t.step(toks) for _ in range(3)]
    got = [port.step(toks)] + [port.run(toks, 1) for _ in range(2)]
    assert got == pytest.approx(want, abs=1e-5)
    pp = _port_pp(attention="dense")
    assert [pp.step(toks), pp.run(toks, 2)] == pytest.approx(
        [want[0], want[2]], abs=1e-5)


def test_transformer_apply_flash_gradients_match_dense():
    """`transformer_apply(causal=True, attention="flash")` under autograd:
    its parameter gradients are the dense path's within 1e-5 of their max
    |value| (f32, the same rounding points; sums in other orders)."""
    grads = []
    toks = torch.as_tensor(_tokens()[0])
    w = torch.as_tensor(np.random.default_rng(1).normal(size=(32, 32))
                        .astype(np.float32))
    for attention in ("flash", "dense"):
        params = params_from_numpy(init_transformer(**_KW), "cpu")
        leaves = [params["embed"], params["layers"][0]["wq"],
                  params["layers"][1]["w1"]]
        for a in leaves:
            a.requires_grad_(True)
        out = transformer_apply(params, toks, causal=True,
                                attention=attention)
        (out * w).sum().backward()
        grads.append([a.grad for a in leaves])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_validation_and_unported_paths():
    for bad, match in ((dict(attention="ring"), "attention must be"),
                       (dict(optimizer="lamb"), "optimizer must be"),
                       (dict(remat=1), "remat must be"),
                       (dict(remat="everything"), "remat must be"),
                       (dict(compute_dtype="float16"), "compute_dtype")):
        with pytest.raises(ValueError, match=match):
            _port_pp(**bad)
    # what a mesh still cannot do: a pipe or model axis > 1, and the
    # ShardedLMTrainer's GSPMD layout (the data and seq axes are ported)
    for shape in ((1, 2), (1, 1, 2)):
        axes = (DATA_AXIS, PIPE_AXIS, MODEL_AXIS)[:len(shape)]
        with pytest.raises(NotImplementedError, match="item 15"):
            PipelinedLMTrainer(mesh=port_grid_mesh(shape, axes,
                                                   devices=["cpu"] * 2),
                               **_KW)
    with pytest.raises(NotImplementedError, match="item 15"):
        ShardedLMTrainer(mesh=port_grid_mesh((1, 1), devices=["cpu"]),
                         device="cpu", **_KW)
    with pytest.raises(ValueError, match="must divide by n_heads"):
        ShardedLMTrainer(device="cpu", **{**_KW, "n_heads": 3})
    t = _port_pp()
    with pytest.raises(ValueError, match="dp\\*microbatches = 2"):
        t.step(_tokens()[:3])
    with pytest.raises(TypeError):
        t.run(_tokens(), 2.9)
    with pytest.raises(ValueError, match="n_steps must be >= 1"):
        t.run(_tokens(), 0)
    s = ShardedLMTrainer(device="cpu", **_KW)
    with pytest.raises(NotImplementedError, match="item 17"):
        s.run_stream([_tokens()])
