"""Port parity: ring and Ulysses sequence-parallel attention
(`mmlspark_tpu_torch.parallel.ring_attention`) and the mesh constructors
(`mmlspark_tpu_torch.parallel.mesh`).

The JAX package runs on the 8-device virtual CPU mesh of conftest.py
(`data_mesh(P)`, real shard_map collectives); the port runs the same
program from one process over `data_mesh(devices=["cpu"] * P)`, the
single-controller form of that virtual mesh. The same seeded numpy
inputs go through both. Tolerances, as tests/test_ring_attention.py
holds the reference to its oracle:
- f32, dense and flash blocks, against the JAX ring and against
  `reference_attention`: 2e-5 (the same f32 math, sums in other orders
  and a streaming merge against one softmax);
- bf16 flash: 2e-2 against f32 attention (the reference test's bound;
  p and the output are rounded to bf16) and 2^-7 relative (a bf16 ulp)
  against the JAX ring in bf16;
- the gradient of the flash ring (through the stats VJP): 1e-4 of its max
  against autograd through `reference_attention` in f32;
- the encoder with attention="ring"/"ulysses" over the same meshes: 2e-4,
  the tolerance of tests/test_torch_transformer.py's encoder parity.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.dnn import transformer as jax_transformer
from mmlspark_tpu.parallel import data_mesh as jax_data_mesh
from mmlspark_tpu.parallel.ring_attention import \
    ring_attention as jax_ring
from mmlspark_tpu.parallel.ring_attention import \
    ulysses_attention as jax_ulysses
from mmlspark_tpu_torch.models.dnn import transformer as port_transformer
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.parallel import (DATA_AXIS, SEQ_AXIS, Mesh,
                                         data_mesh, grid_mesh)
from mmlspark_tpu_torch.parallel.ring_attention import (reference_attention,
                                                        ring_attention,
                                                        ulysses_attention)

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seq=128, heads=4, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(seq, heads, dim)).astype(np.float32)
                 for _ in range(3))


def _cpu_mesh(n):
    return data_mesh(devices=["cpu"] * n)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block_impl", ["dense", "flash"])
def test_ring_matches_jax_and_oracle(n, causal, block_impl):
    q, k, v = _qkv()
    want = np.asarray(jax_ring(*(jnp.asarray(a) for a in (q, k, v)),
                               mesh=jax_data_mesh(n), causal=causal,
                               block_impl=block_impl))
    qt, kt, vt = (torch.as_tensor(a) for a in (q, k, v))
    got = ring_attention(qt, kt, vt, mesh=_cpu_mesh(n), causal=causal,
                         block_impl=block_impl)
    assert got.shape == (128, 4, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **_TOL)
    np.testing.assert_allclose(
        got.numpy(), reference_attention(qt, kt, vt, causal=causal).numpy(),
        **_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax_and_oracle(causal):
    q, k, v = _qkv()
    want = np.asarray(jax_ulysses(*(jnp.asarray(a) for a in (q, k, v)),
                                  mesh=jax_data_mesh(4), causal=causal))
    qt, kt, vt = (torch.as_tensor(a) for a in (q, k, v))
    got = ulysses_attention(qt, kt, vt, mesh=_cpu_mesh(4), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, **_TOL)
    np.testing.assert_allclose(
        got.numpy(), reference_attention(qt, kt, vt, causal=causal).numpy(),
        **_TOL)


def test_ulysses_rejects_indivisible_heads():
    q, k, v = (torch.as_tensor(a[:, :3]) for a in _qkv())
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, k, v, mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention(*(torch.as_tensor(a[:100]) for a in _qkv()),
                       mesh=_cpu_mesh(8))


def test_ring_flash_bf16_and_grad():
    """After tests/test_ring_attention.py:99-120: bf16 inputs through the
    flash ring (f32 carries, a bf16 result) and the flash ring's gradient
    through the stats VJP."""
    q, k, v = _qkv(seq=128, heads=2, dim=32, seed=5)
    mesh = _cpu_mesh(8)
    qb, kb, vb = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    out = ring_attention(qb, kb, vb, mesh=mesh, causal=True,
                         block_impl="flash")
    assert out.dtype == torch.bfloat16
    ref = reference_attention(qb.float(), kb.float(), vb.float(), causal=True)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=2e-2,
                               atol=2e-2)
    want = np.asarray(jax_ring(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)),
                               mesh=jax_data_mesh(8), causal=True,
                               block_impl="flash"), np.float32)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2.0 ** -7,
                               atol=2.0 ** -7 * np.abs(want).max())

    w = torch.as_tensor(np.random.default_rng(6).normal(size=q.shape)
                        .astype(np.float32))
    grads = []
    for fn in (lambda a, b, c: ring_attention(a, b, c, mesh=mesh,
                                              causal=True,
                                              block_impl="flash"),
               lambda a, b, c: reference_attention(a, b, c, causal=True)):
        qkv = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
        (fn(*qkv) * w).sum().backward()
        grads.append([t.grad for t in qkv])
    for g, r in zip(*grads):
        tol = 1e-4 * float(r.abs().max())
        assert float((g - r).abs().max()) <= tol


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_encoder_sequence_parallel_matches_jax(attention, causal):
    """`transformer_apply(attention=ring|ulysses, mesh=...)` and the
    stage's `encode_long(tokens, mesh)`, against the JAX package's on a
    4-position mesh."""
    kw = dict(d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=128)
    tree = jax_transformer.init_transformer(vocab_size=50, **kw)
    toks = np.random.default_rng(3).integers(0, 50, 96).astype(np.int32)
    want = np.asarray(jax_transformer.transformer_apply(
        tree, toks, causal=causal, attention=attention,
        mesh=jax_data_mesh(4)))
    params = port_transformer.params_from_numpy(tree, device="cpu")
    got = port_transformer.transformer_apply(
        params, torch.as_tensor(toks), causal=causal, attention=attention,
        mesh=_cpu_mesh(4))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    if causal:
        return
    want = jax_transformer.TransformerSentenceEncoder(
        attention=attention, **kw).encode_long(toks, mesh=jax_data_mesh(4))
    got = port_transformer.TransformerSentenceEncoder(
        attention=attention, device="cpu", **kw).encode_long(
            toks, mesh=_cpu_mesh(4))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_single_position_takes_the_normalized_route(monkeypatch):
    """An axis of one position is ordinary attention: the flash ring calls
    the normalized forward once and the stats forward never."""
    calls = {"normalized": 0, "stats": 0}
    norm, stats = fa.flash_forward_lse, fa.flash_stats_forward

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(fa, "flash_forward_lse", count("normalized", norm))
    monkeypatch.setattr(fa, "flash_stats_forward", count("stats", stats))
    qt, kt, vt = (torch.as_tensor(a) for a in _qkv())
    got = ring_attention(qt, kt, vt, mesh=_cpu_mesh(1), causal=True,
                         block_impl="flash")
    assert calls == {"normalized": 1, "stats": 0}
    np.testing.assert_allclose(
        got.numpy(), reference_attention(qt, kt, vt, causal=True).numpy(),
        **_TOL)
    ring_attention(qt, kt, vt, mesh=_cpu_mesh(4), causal=True,
                   block_impl="flash")
    assert calls == {"normalized": 1, "stats": 16}


def test_mesh_constructors(monkeypatch):
    mesh = grid_mesh((1, 4), (DATA_AXIS, SEQ_AXIS), devices=["cpu"] * 4)
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 1, "seq": 4}
    assert mesh.axis_devices(SEQ_AXIS) == [torch.device("cpu")] * 4
    assert data_mesh(2, devices=["cpu"] * 3).shape == {"data": 2}
    with pytest.raises(ValueError, match="devices="):
        grid_mesh((2, 2), (DATA_AXIS, SEQ_AXIS), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array([torch.device("cpu")] * 2, dtype=object),
             (DATA_AXIS, SEQ_AXIS))
    # no devices given: the visible cards, never a repeated one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        data_mesh()
    with pytest.raises(RuntimeError, match="devices="):
        ring_attention(*(torch.as_tensor(a) for a in _qkv()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert data_mesh().shape == {"data": 1}
    with pytest.raises(ValueError, match="devices="):
        grid_mesh((1, 4), (DATA_AXIS, SEQ_AXIS))
