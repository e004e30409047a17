"""Port parity: flash attention and dense attention
(`mmlspark_tpu_torch.ops.flash_attention`,
`mmlspark_tpu_torch.parallel.ring_attention`).

The port's plain flash version (what a CPU tensor takes) against the JAX
package's Pallas kernel in interpret mode, as tests/test_flash_attention.py
runs it, on the same seeded numpy inputs:
- f32 out and lse at rtol/atol 2e-5, the tolerance of
  tests/test_flash_attention.py (both sides sum exact f32 products, in
  another order);
- bf16 out, per element, to 2^-7 |reference| + 2^-6 r with
  r = `_bf16_rounding_scale` (sqrt(sum p^2 v^2) / sum p): one bf16 ulp of
  the output plus ~10 standard deviations of what rounding p at another
  point does (the reference rounds p to bf16 against each block's running
  max, the plain version against the row's final max).
The CUDA kernel is held against the plain version on the card in
tests/test_torch_flash_attention_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.flash_attention import _flash_forward_lse
from mmlspark_tpu.ops.flash_attention import flash_attention as jax_flash
from mmlspark_tpu.parallel.ring_attention import \
    reference_attention as jax_reference
from mmlspark_tpu_torch.ops import flash_attention as fa
from mmlspark_tpu_torch.parallel import data_mesh
from mmlspark_tpu_torch.parallel import ring_attention as ra

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)


def _qkv(sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(s, h, d)).astype(np.float32)
                 for s in (sq, sk, sk))


def _t(*arrays, dtype=torch.float32):
    return tuple(torch.as_tensor(a).to(dtype) for a in arrays)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,h,d,block", [
    (384, 384, 4, 64, 128),     # not a block multiple: the ragged edge
    (96, 320, 2, 32, 128),      # cross shapes, Sk > Sq
    (64, 40, 1, 32, 64),        # Sk < one block: padded keys drop out
])
def test_plain_flash_matches_jax_flash(sq, sk, h, d, block, causal):
    q, k, v = _qkv(sq, sk, h, d, seed=sq + sk)
    want = np.asarray(jax_flash(q, k, v, causal=causal, block_q=block,
                                block_k=block))
    got = fa.flash_attention(*_t(q, k, v), causal=causal)
    assert got.shape == (sq, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(300, 300), (96, 40)])
def test_lse_matches_jax_forward_lse(sq, sk, causal):
    """out and lse against `_flash_forward_lse` (per-head layout, lse
    (H, S, 1)); (96, 40) causal is the top-left-aligned cross shape."""
    q, k, v = _qkv(sq, sk, 2, 32, seed=7)
    scale = 0.2
    want, want_lse = _flash_forward_lse(
        *(jnp.moveaxis(jnp.asarray(a), 1, 0) for a in (q, k, v)), causal,
        scale, 64, 64, True)
    got, got_lse = fa.flash_forward_lse(*_t(q, k, v), causal, scale)
    np.testing.assert_allclose(got.numpy(),
                               np.moveaxis(np.asarray(want), 0, 1),
                               rtol=2e-5, atol=2e-5)
    assert got_lse.shape == (2, sq) and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse)[..., 0],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_plain_flash_matches_jax_flash(causal):
    q, k, v = _qkv(256, 256, 2, 64, seed=5)
    want = jax_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                     causal=causal, block_q=128, block_k=128)
    qt, kt, vt = _t(q, k, v, dtype=torch.bfloat16)
    got = fa.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    r = fa._bf16_rounding_scale(qt, kt, vt, causal, 1 / 8)
    limit = 2.0 ** -7 * want.abs() + 2.0 ** -6 * r
    assert bool(((got.float() - want).abs() <= limit).all())


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_rounding_scale_matches_direct_sum(causal):
    """sqrt(sum_j p_j^2 v_j^2) / sum_j p_j, summed directly over the dense
    softmax weights, and the limit built on it rejects V one key off."""
    q, k, v = _t(*_qkv(80, 120, 2, 16, seed=9))
    scale = 0.3
    s = torch.einsum("qhd,khd->hqk", q * scale, k)
    if causal:
        s.masked_fill_(torch.arange(80)[:, None] < torch.arange(120), -1e30)
    p = torch.softmax(s, -1)
    want = torch.einsum("hqk,khd->qhd", p * p, v * v).sqrt()
    got = fa._bf16_rounding_scale(q, k, v, causal, scale)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)
    bq, bk, bv = (t.bfloat16() for t in (q, k, v))
    out = fa._flash_forward_lse_plain(bq, bk, bv, causal, scale)[0].float()
    shifted = fa._flash_forward_lse_plain(bq, bk, bv.roll(1, 0), causal,
                                          scale)[0].float()
    limit = 2.0 ** -7 * out.abs() + 2.0 ** -6 * got
    assert float(((shifted - out).abs() > limit).float().mean()) > 0.5


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(causal, dtype, tol):
    """The dense path, with a key mask that empties one row's keys
    entirely (an empty document -> 0). bf16: the same rounding points on
    both sides (q * bf16(scale), p to bf16), one bf16 ulp apart at most."""
    q, k, v = _qkv(48, 48, 4, 16, seed=3)
    key_mask = np.arange(48) < 30
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_reference(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                         causal=causal, key_mask=jnp.asarray(key_mask))
    got = ra.reference_attention(*_t(q, k, v, dtype=dtype), causal=causal,
                                 key_mask=torch.as_tensor(key_mask))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=tol)
    empty = ra.reference_attention(*_t(q, k, v), causal=causal,
                                   key_mask=torch.zeros(48, dtype=torch.bool))
    assert torch.equal(empty, torch.zeros_like(empty))


def test_reference_attention_batch_dim_is_a_loop():
    """The leading batch dimension (the stage's batched transform) gives
    what each sequence gives alone, masks per sequence."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.as_tensor(rng.normal(size=(3, 20, 2, 8)).astype(
        np.float32)) for _ in range(3))
    mask = torch.as_tensor(np.arange(20)[None, :] < np.array([[20], [7], [0]]))
    batched = ra.reference_attention(q, k, v, key_mask=mask)
    for b in range(3):
        alone = ra.reference_attention(q[b], k[b], v[b], key_mask=mask[b])
        torch.testing.assert_close(batched[b], alone, rtol=1e-6, atol=1e-6)


def test_gradient_raises_instead_of_vanishing():
    """An input that requires grad keeps an autograd node, and its
    backward gives a gradient (the plain backward on the CPU) instead of
    silently none; the backward raises on operands it cannot take."""
    q, k, v = _t(*_qkv(32, 32, 2, 16))
    q.requires_grad_(True)
    out = fa.flash_attention(q, k, v, causal=True)
    assert out.requires_grad
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    assert float(q.grad.abs().max()) > 0
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_backward(q.detach(), k, v, q.detach(), torch.zeros(2, 31),
                          torch.zeros(2, 32), True, 0.25)


def test_tpu_knobs_and_unsupported_inputs_rejected():
    q, k, v = _t(*_qkv(32, 32, 2, 16))
    for knob in ("block_q", "block_k", "interpret"):
        with pytest.raises(ValueError, match=knob):
            fa.flash_attention(q, k, v, **{knob: 128})
    with pytest.raises(ValueError, match="share a dtype"):
        fa.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError, match="heads or head dim"):
        fa.flash_attention(q, k[:, :1], v[:, :1])
    with pytest.raises(ValueError, match="no flash-attention path"):
        fa.flash_forward_lse(*(t.to("meta") for t in (q, k, v)), False, 0.25)
    with pytest.raises(ValueError, match="CUDA flash kernel"):
        fa.flash_fwd(q, k, v, False, 0.25)
    # what the sequence-parallel paths still refuse: Ulysses over more
    # positions than heads, a sequence the axis does not divide
    with pytest.raises(ValueError, match="divisible"):
        ra.ulysses_attention(q, k, v, mesh=data_mesh(devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="not divisible"):
        ra.ring_attention(q, k, v, mesh=data_mesh(devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="block_impl"):
        ra.ring_attention(q, k, v, mesh=data_mesh(devices=["cpu"] * 2),
                          block_impl="sparse")
