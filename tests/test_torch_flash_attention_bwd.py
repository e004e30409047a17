"""Port parity: the flash-attention backward
(`mmlspark_tpu_torch.ops.flash_attention`, what a CPU tensor takes: the
plain version `_flash_backward_plain`).

The same seeded numpy inputs go through the port's `flash_attention`
under autograd and through `jax.grad` of the JAX package's
`flash_attention`, whose Pallas backward kernels run in interpret mode, as
tests/test_flash_attention.py runs them:
- f32 gradients within 2e-5 of each gradient's max |value| (the JAX test
  holds its kernels to 2e-4 of dense; both sides here sum exact f32
  products in other orders);
- bf16 at S=2048 within 2^-8 (one bf16 ulp at the top binade) of each
  gradient's max |value|, far tighter than the JAX test's 5e-2 (the gap
  measured 1.1e-3 of the max): the two forwards round p to bf16 against
  other maxima (a block's running max against the row's), so their
  outputs, and the dsum = rowsum(dO * O) built on them, differ by bf16
  ulps before the backward starts;
- the backward alone, from one forward's out and lse, per element within
  `_BWD_TOL` (f32: a few ulps plus ~10 standard deviations of summing in
  another order; bf16: one output ulp plus the terms whose p or ds rounds
  to the neighbouring bf16 value on one side only).
The CUDA kernels are held against the plain version on the card in
tests/test_torch_flash_attention_bwd_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.flash_attention import _flash_backward, \
    _flash_forward_lse
from mmlspark_tpu.ops.flash_attention import flash_attention as jax_flash
from mmlspark_tpu_torch.ops import flash_attention as fa

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)


def _arrays(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32) for s in shapes)


def _port_grads(q, k, v, w, causal, dtype):
    qt, kt, vt = (torch.as_tensor(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    out = fa.flash_attention(qt, kt, vt, causal=causal)
    (out.float() * torch.as_tensor(w)).sum().backward()
    return qt.grad, kt.grad, vt.grad


def _jax_grads(q, k, v, w, causal, dtype):
    return jax.grad(lambda a, b, c: (jax_flash(a, b, c, causal=causal)
                                     .astype(jnp.float32) * w).sum(),
                    argnums=(0, 1, 2))(*(jnp.asarray(x, dtype)
                                         for x in (q, k, v)))


@pytest.mark.parametrize("sq,sk,h,d,causal", [(300, 300, 2, 64, True),
                                              (200, 333, 2, 64, False),
                                              (256, 256, 1, 32, True)])
def test_f32_gradients_match_jax_flash(sq, sk, h, d, causal):
    q, k, v, w = _arrays((sq, h, d), (sk, h, d), (sk, h, d), (sq, h, d),
                         seed=sq + sk)
    got = _port_grads(q, k, v, w, causal, torch.float32)
    want = _jax_grads(q, k, v, w, causal, jnp.float32)
    for name, g, r in zip("qkv", got, want):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 2e-5 * float(np.abs(r).max()), (name, err)


def test_bf16_gradients_match_jax_flash():
    """The JAX test's bf16 shape: S=2048, causal, long enough for the
    reference's 1024-wide blocks and maskless interior."""
    q, k, v = _arrays((2048, 2, 64), (2048, 2, 64), (2048, 2, 64), seed=5)
    got = _port_grads(q, k, v, np.ones((2048, 2, 64), np.float32), True,
                      torch.bfloat16)
    want = _jax_grads(q, k, v, 1.0, True, jnp.bfloat16)
    for name, g, r in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16, name
        r = np.asarray(r.astype(jnp.float32))
        err = float(np.abs(g.float().numpy() - r).max())
        assert err <= 2.0 ** -8 * float(np.abs(r).max()), (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,causal", [(300, 300, True),
                                          (96, 160, False)])
def test_backward_alone_matches_jax_kernels(sq, sk, causal, dtype):
    """`flash_backward` on the CPU against the reference's `_flash_backward`
    (its two kernels, interpreted) from the same out, lse and dO: the
    per-element limits of the kernels' own check."""
    h, d, scale = 2, 64, 0.125
    q, k, v, g = _arrays((sq, h, d), (sk, h, d), (sk, h, d), (sq, h, d),
                         seed=11)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    qh, kh, vh, gh = (jnp.moveaxis(jnp.asarray(a, jdt), 1, 0)
                      for a in (q, k, v, g))
    out, lse = _flash_forward_lse(qh, kh, vh, causal, scale, 64, 64, True)
    want = _flash_backward(qh, kh, vh, out, lse, gh, causal, scale, 64, 64,
                           True)
    tq, tk, tv, tg = (torch.as_tensor(a).to(dtype) for a in (q, k, v, g))
    t_out = torch.as_tensor(np.moveaxis(
        np.array(out.astype(jnp.float32)), 0, 1)).to(dtype)
    t_lse = torch.as_tensor(np.asarray(lse)[..., 0])
    dsum = (tg.float() * t_out.float()).sum(-1).T.contiguous()
    got = fa.flash_backward(tq, tk, tv, tg, t_lse, dsum, causal, scale)
    want = tuple(torch.as_tensor(np.moveaxis(
        np.array(w.astype(jnp.float32)), 0, 1)) for w in want)
    lims = fa._bwd_limits(tq, tk, tv, tg, t_lse, dsum, causal, scale, want)
    for name, a, b, lim in zip("qkv", got, want, lims):
        assert a.dtype == dtype, name
        used = float(((a.float() - b).abs() / lim).max())
        assert used <= 1.0, (name, used)


def test_gradient_dtypes_and_needs_input_grad():
    """Gradients come back in the inputs' dtypes, and only for the inputs
    that require one."""
    q, k, v = _arrays((64, 2, 16), (64, 2, 16), (64, 2, 16), seed=2)
    qt, kt = torch.as_tensor(q).bfloat16(), torch.as_tensor(k).bfloat16()
    vt = torch.as_tensor(v).bfloat16().requires_grad_()
    fa.flash_attention(qt, kt, vt, causal=True).float().sum().backward()
    assert qt.grad is None and kt.grad is None
    assert vt.grad.dtype == torch.bfloat16 and vt.grad.shape == (64, 2, 16)
    # a flash gradient equals the dense one's (f32, same rounding points)
    from mmlspark_tpu_torch.parallel.ring_attention import \
        reference_attention
    grads = []
    for fn in (fa.flash_attention, reference_attention):
        ts = [torch.as_tensor(a).requires_grad_() for a in (q, k, v)]
        fn(*ts, causal=True).pow(2).sum().backward()
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
