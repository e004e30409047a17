"""Port parity: the flash stats forward and its backward
(`mmlspark_tpu_torch.ops.flash_attention.flash_attention_stats`; what a
CPU tensor takes: the plain versions `_flash_stats_plain` and
`_flash_backward_plain` inside `_FlashStats`).

The same seeded numpy inputs go through the port and through the JAX
package's `flash_attention_stats`, whose Pallas kernels run in interpret
mode, as tests/test_flash_attention.py runs them, for one
(q shard, kv shard) pair of ring attention at global offsets: diagonal,
fully visible, fully masked (every row flagged) and non-causal. Rows with
no visible key are flagged by m == -1e30 in both packages and compared
only for that flag (ROADMAP Queue 3 (c): the reference leaves them
garbage). Tolerances:
- f32: m and l within 2e-6 relative, acc within 2e-5 of its row's
  max |acc| (both sides sum exact f32 products in other orders);
- bf16: the same for m (f32 scores of the same bf16 inputs); acc within
  2^-8 and l within 2^-16 relative. The JAX kernel's 256-key block holds
  every key of these shards, so both sides round p against the row's
  final max; what differs is the f32 summation order.
- gradients of a shift-invariant consumer (the normalized output and the
  log-sum-exp of the pair, flagged rows weighted 0, as the ring merge
  weighs them): f32 within 2e-5 of each gradient's max |value| against
  the JAX VJP and against torch autograd through a dense stats function,
  whose d_m the flash backward drops; bf16 within 2^-7 of the max
  against the JAX VJP (ds and p rounded to bf16 at the same points on
  both sides, from forwards that agree to bf16 ulps).
The CUDA kernels are held against the plain versions on the card in
tests/test_torch_flash_stats_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.flash_attention import \
    flash_attention_stats as jax_stats
from mmlspark_tpu_torch.ops import flash_attention as fa

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_S, _H, _D = 128, 2, 32
_SCALE = 1.0 / _D ** 0.5
# (q_offset, k_offset, causal): one shard of 128 rows against another
_PAIRS = {"diagonal": (128, 128, True), "full": (384, 0, True),
          "masked": (0, 384, True), "noncausal": (0, 384, False)}


def _arrays(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(_S, _H, _D)).astype(np.float32)
                 for _ in range(n))


def _flagged(m):
    return np.asarray(m) <= -1e29


def _port(q, k, v, pair, dtype):
    qo, ko, causal = _PAIRS[pair]
    return fa.flash_attention_stats(*(torch.as_tensor(a).to(dtype)
                                      for a in (q, k, v)),
                                    qo, ko, causal, _SCALE)


def _jax(q, k, v, pair, dtype):
    qo, ko, causal = _PAIRS[pair]
    return jax_stats(*(jnp.asarray(a, dtype) for a in (q, k, v)), qo, ko,
                     causal, _SCALE)


@pytest.mark.parametrize("pair", list(_PAIRS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stats_match_jax(pair, dtype):
    q, k, v = _arrays()
    acc, m, l = _port(q, k, v, pair, getattr(torch, dtype))
    j_acc, j_m, j_l = (np.asarray(x, np.float32)
                       for x in _jax(q, k, v, pair, getattr(jnp, dtype)))
    assert acc.shape == (_S, _H, _D) and m.shape == l.shape == (_H, _S)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    acc, m, l = acc.numpy(), m.numpy(), l.numpy()
    assert np.isfinite(acc).all() and np.isfinite(l).all()
    flagged = _flagged(m)
    np.testing.assert_array_equal(flagged, _flagged(j_m))
    assert flagged.all() == (pair == "masked")
    # the port's flagged rows are what its kernel writes: all tiles skipped
    assert (acc[flagged.T] == 0).all() and (l[flagged] == 0).all()
    ok = ~flagged
    np.testing.assert_allclose(m[ok], j_m[ok], rtol=2e-6, atol=2e-6)
    acc_rtol, l_rtol = ((2e-5, 2e-6) if dtype == "float32"
                        else (2.0 ** -8, 2.0 ** -16))
    np.testing.assert_allclose(l[ok], j_l[ok], rtol=l_rtol)
    for row in np.argwhere(ok):
        h, i = row
        want = j_acc[i, h]
        assert np.abs(acc[i, h] - want).max() <= \
            acc_rtol * np.abs(want).max(), (pair, h, i)


def _consumer(w, u, acc, m, l):
    """A shift-invariant readout of one pair's stats, as a merge reads
    them: the normalized output and the log-sum-exp, flagged rows
    weighted 0 (`w` (S, H, D), `u` (H, S), `live` from the caller)."""
    return (w * acc / l.clamp_min(1e-30).T[:, :, None]).sum() \
        + (u * (m + l.clamp_min(1e-30).log())).sum()


def _jax_consumer(w, u, acc, m, l):
    return (w * acc / jnp.maximum(l, 1e-30).T[:, :, None]).sum() \
        + (u * (m + jnp.log(jnp.maximum(l, 1e-30)))).sum()


def _port_grads(q, k, v, w, u, pair, dtype):
    qt, kt, vt = (torch.as_tensor(a).to(dtype).requires_grad_()
                  for a in (q, k, v))
    qo, ko, causal = _PAIRS[pair]
    acc, m, l = fa.flash_attention_stats(qt, kt, vt, qo, ko, causal, _SCALE)
    _consumer(torch.as_tensor(w), torch.as_tensor(u), acc, m, l).backward()
    return [t.grad.float().numpy() for t in (qt, kt, vt)]


def _dense_stats(q, k, v, pair):
    """The stats contract in dense f32 torch, differentiable through m
    too (the reference's `_stats_xla_reference`)."""
    qo, ko, causal = _PAIRS[pair]
    s = torch.einsum("qhd,khd->hqk", q, k) * _SCALE
    if causal:
        s = s.masked_fill(fa._causal_mask(_S, _S, qo, ko, q.device), -1e30)
    m = s.amax(-1).clamp_min(-1e30)
    p = torch.exp(s - m[..., None])
    return torch.einsum("hqk,khd->qhd", p, v), m, p.sum(-1)


def _weights(pair, seed=1):
    """Seeded cotangent weights, 0 on the pair's flagged rows."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(_S, _H, _D)).astype(np.float32)
    u = rng.normal(size=(_H, _S)).astype(np.float32)
    q, k, v = _arrays()
    live = ~_flagged(_port(q, k, v, pair, torch.float32)[1].numpy())
    return w * live.T[:, :, None], u * live


@pytest.mark.parametrize("pair", list(_PAIRS))
def test_f32_gradients_match_jax_and_dense_autograd(pair):
    q, k, v = _arrays()
    w, u = _weights(pair)
    got = _port_grads(q, k, v, w, u, pair, torch.float32)
    want = jax.grad(lambda a, b, c: _jax_consumer(
        w, u, *_jax_stats_f32(a, b, c, pair)), argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in (q, k, v)))
    qt, kt, vt = (torch.as_tensor(a).requires_grad_() for a in (q, k, v))
    _consumer(torch.as_tensor(w), torch.as_tensor(u),
              *_dense_stats(qt, kt, vt, pair)).backward()
    for g, j, d in zip(got, want, (qt.grad, kt.grad, vt.grad)):
        j, d = np.asarray(j), d.numpy()
        if pair == "masked":
            assert not g.any() and not j.any() and not d.any()
            continue
        np.testing.assert_allclose(g, j, atol=2e-5 * np.abs(j).max())
        np.testing.assert_allclose(g, d, atol=2e-5 * np.abs(d).max())


def _jax_stats_f32(a, b, c, pair):
    qo, ko, causal = _PAIRS[pair]
    return jax_stats(a, b, c, qo, ko, causal, _SCALE)


@pytest.mark.parametrize("pair", ["diagonal", "full"])
def test_bf16_gradients_match_jax(pair):
    q, k, v = _arrays()
    w, u = _weights(pair)
    got = _port_grads(q, k, v, w, u, pair, torch.bfloat16)
    want = jax.grad(lambda a, b, c: _jax_consumer(
        w, u, *_jax_stats_f32(a, b, c, pair)), argnums=(0, 1, 2))(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    for g, j in zip(got, want):
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(g, j, atol=2.0 ** -7 * np.abs(j).max())


def test_backward_takes_f32_cotangent_and_drops_dm(monkeypatch):
    """The stats VJP calls the shared backward with lse := m,
    dsum := -d_l and dO := d_acc in f32 (for bf16 inputs too), at the
    pair's offsets, and returns gradients in the inputs' dtypes."""
    seen = {}
    plain = fa._flash_backward_plain

    def spy(q, k, v, do, lse, dsum, causal, scale, q_offset, k_offset):
        seen.update(do=do.dtype, offsets=(q_offset, k_offset),
                    lse=lse.clone(), dsum=dsum.clone())
        return plain(q, k, v, do, lse, dsum, causal, scale, q_offset,
                     k_offset)
    monkeypatch.setattr(fa, "_flash_backward_plain", spy)
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16).requires_grad_()
               for a in _arrays())
    acc, m, l = fa.flash_attention_stats(q, k, v, 128, 128, True, _SCALE)
    d_l = torch.as_tensor(np.random.default_rng(2).normal(size=(_H, _S))
                          .astype(np.float32))
    (acc.sum() + (m * 3.0).sum() + (l * d_l).sum()).backward()
    assert seen["do"] == torch.float32 and seen["offsets"] == (128, 128)
    assert torch.equal(seen["lse"], m.detach())
    assert torch.equal(seen["dsum"], -d_l)
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16


def test_rejects_tpu_knobs():
    q, k, v = (torch.as_tensor(a) for a in _arrays())
    for knob in ("block_q", "block_k", "interpret"):
        with pytest.raises(ValueError, match=knob):
            fa.flash_attention_stats(q, k, v, 0, 0, True, _SCALE,
                                     **{knob: 128})
    with pytest.raises(ValueError, match="CUDA flash kernel"):
        fa.flash_stats_fwd(q, k, v, 0, 0, True, _SCALE)
