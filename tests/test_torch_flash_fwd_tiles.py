"""The bf16 tensor-core flash forward's order of arithmetic, rehearsed on
the CPU against the JAX reference and the port's plain versions.

`csrc/flash_attention.cu::flash_fwd_mma` runs only on the card. Its
arithmetic is emulated here in torch, step for step:
- q * bf16(scale) rounded to bf16, as the reference scales it;
- 64-key tiles; each score is summed in 16-deep chunks (one tensor-core
  step each: exact bf16 products summed in f32), the chunks added in f32;
- the -1e30 mask; a running max m; alpha = 2^((m_old - m_new) log2 e);
- p = 2^(fma(s, log2 e, -m log2 e)) in f32, with 0 in place of m log2 e
  while a row has no visible key (its masked p are then 0);
- l sums the unrounded p; p is rounded to bf16, against the tile's
  running max, for the PV product; acc is rescaled by alpha each tile;
- out = acc / max(l, 1e-30) in bf16, lse = m + log(max(l, 1e-30)).

The emulation is held, at small widths, against the reference's flash
forward (its Pallas kernel in interpret mode with 64-key blocks, as
tests/test_flash_attention.py runs it) and against the port's plain
versions, in both forms, causal and not, at zero and nonzero global
offsets, within the card check's own limits (`chip_smoke._bf16_limit`:
2^-7 |want| + 2^-6 r per element; `_LSE_TOL` for lse and m): the limits
pinned before any card run. The same limit rejects the emulation run on V
read one key off. Inputs come from seeded numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mmlspark_tpu.ops.flash_attention import _flash_forward_lse
from mmlspark_tpu.ops.flash_attention import \
    flash_attention_stats as jax_stats
from mmlspark_tpu_torch.ops import flash_attention as fa

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_TILE, _CHUNK = 64, 16
_LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
_MASK = -1e30
_H, _D = 2, 32
_SCALE = 1.0 / _D ** 0.5
# (q_offset, k_offset, causal) of one 160-row shard against another: on
# the 64-key grid, off it by one key (rows without a visible key in a
# computed tile), fully visible, fully masked and non-causal
_PAIRS = {"diagonal": (160, 160, True), "off_grid": (160, 161, True),
          "full": (480, 0, True), "masked": (0, 480, True),
          "noncausal": (0, 480, False)}


def _inputs(sq, sk, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(s, _H, _D)).astype(np.float32)
                 for s in (sq, sk, sk))


def _bf16(*arrays):
    return tuple(torch.as_tensor(a).to(torch.bfloat16) for a in arrays)


def _fma(a, b, c):
    """a * b + c in f32 with one rounding (the f64 product is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _emulate(q, k, v, causal, scale, q_offset=0, k_offset=0):
    """(acc (Sq, H, D), m (H, Sq), l (H, Sq)), all f32, of bf16 q, k, v in
    the tensor-core kernel's order of arithmetic (the module docstring).
    A tile the kernel skips (every key after every row of its 64-row block)
    would change nothing here: its p are 0 and its max leaves m as it is."""
    sq, sk = q.shape[0], k.shape[0]
    qs, kf, vf = fa._scaled(q, scale).float(), k.float(), v.float()
    m = torch.full((_H, sq), _MASK)
    l = torch.zeros(_H, sq)
    acc = torch.zeros(_H, sq, _D)
    q_pos = torch.arange(sq)[:, None] + q_offset
    for k0 in range(0, sk, _TILE):
        kt, vt = kf[k0:k0 + _TILE], vf[k0:k0 + _TILE]
        s = torch.zeros(_H, sq, kt.shape[0])
        for d0 in range(0, _D, _CHUNK):
            s = s + torch.einsum("qhd,khd->hqk", qs[..., d0:d0 + _CHUNK],
                                 kt[..., d0:d0 + _CHUNK])
        if causal:
            k_pos = torch.arange(k0, k0 + kt.shape[0])[None, :] + k_offset
            s = s.masked_fill(q_pos < k_pos, _MASK)
        mn = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - mn) * _LOG2E)
        m_l2e = torch.where(mn == _MASK, 0.0, mn * _LOG2E)
        p = torch.exp2(_fma(s, _LOG2E, -m_l2e[..., None]))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "hqk,khd->hqd", p.to(torch.bfloat16).float(), vt)
        m = mn
    return acc.permute(1, 0, 2).contiguous(), m, l


def _emulate_normalized(q, k, v, causal, scale):
    acc, m, l = _emulate(q, k, v, causal, scale)
    den = l.clamp_min(1e-30)
    return (acc / den.T[:, :, None]).to(torch.bfloat16), m + den.log()


def _lse_used(got, want):
    return cs._limit_used(got, want, cs._LSE_TOL[1]
                          + cs._LSE_TOL[0] * want.abs())


def _jax_normalized(q, k, v, causal, scale):
    """The reference's out (Sq, H, D) and lse (H, Sq), 64-key blocks."""
    out, lse = _flash_forward_lse(
        *(jnp.moveaxis(jnp.asarray(a, jnp.bfloat16), 1, 0)
          for a in (q, k, v)), causal, scale, _TILE, _TILE, True)
    out = np.moveaxis(np.array(out.astype(jnp.float32)), 0, 1)
    return torch.as_tensor(out), torch.as_tensor(np.array(lse)[..., 0])


@pytest.mark.parametrize("reference", ["jax", "plain"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(200, 200), (96, 40), (72, 136)])
def test_normalized_within_the_bf16_limit(sq, sk, causal, reference):
    arrays = _inputs(sq, sk, seed=sq + sk)
    q, k, v = _bf16(*arrays)
    got, got_lse = _emulate_normalized(q, k, v, causal, _SCALE)
    if reference == "jax":
        want, want_lse = _jax_normalized(*arrays, causal, _SCALE)
    else:
        want, want_lse = fa._flash_forward_lse_plain(q, k, v, causal,
                                                     _SCALE)
    lim = cs._bf16_limit(q, k, v, causal, _SCALE, want)
    assert cs._limit_used(got, want, lim) <= 1.0
    assert _lse_used(got_lse, want_lse) <= 1.0


def _live_check(got, want, q, k, v, pair):
    """m and lse within `_LSE_TOL` and acc / l within the bf16 limit, on
    the rows with a visible key (flagged alike on both sides)."""
    qo, ko, causal = _PAIRS[pair]
    acc, m, l = got
    w_acc, w_m, w_l = want
    live = w_m > -1e29
    assert torch.equal(m > -1e29, live)
    if not bool(live.any()):
        return
    out = acc / l.clamp_min(1e-30).T[:, :, None]
    w_out = w_acc / w_l.clamp_min(1e-30).T[:, :, None]
    lim = cs._bf16_limit(q, k, v, causal, _SCALE, w_out, qo, ko)
    assert cs._limit_used(out[live.T], w_out[live.T], lim[live.T]) <= 1.0
    assert _lse_used(m[live], w_m[live]) <= 1.0
    assert _lse_used((m + l.log())[live], (w_m + w_l.log())[live]) <= 1.0


@pytest.mark.parametrize("pair", list(_PAIRS))
def test_stats_match_jax_on_live_rows(pair):
    arrays = _inputs(160, 160, seed=3)
    q, k, v = _bf16(*arrays)
    qo, ko, causal = _PAIRS[pair]
    got = _emulate(q, k, v, causal, _SCALE, qo, ko)
    want = tuple(torch.as_tensor(np.asarray(x, np.float32)) for x in
                 jax_stats(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                           qo, ko, causal, _SCALE, _TILE, _TILE, True))
    _live_check(got, want, q, k, v, pair)


@pytest.mark.parametrize("pair", list(_PAIRS))
def test_stats_pass_the_card_check_against_plain(pair):
    """`chip_smoke._stats_check`, the card check itself: flagged rows
    exactly acc = 0, l = 0, m = -1e30 (which the emulation gives off the
    64-key grid too), live rows within the limits."""
    q, k, v = _bf16(*_inputs(160, 160, seed=3))
    qo, ko, causal = _PAIRS[pair]
    got = _emulate(q, k, v, causal, _SCALE, qo, ko)
    want = fa._flash_stats_plain(q, k, v, qo, ko, causal, _SCALE)
    res = cs._stats_check(got, want, q, k, v, qo, ko, causal, _SCALE)
    assert max(res["m"], res["lse"], res["out"]) <= 1.0, res
    if pair == "off_grid":
        assert bool((got[1][:, 0] == _MASK).all())


@pytest.mark.parametrize("causal", [False, True])
def test_v_one_key_off_fails_the_limit(causal):
    q, k, v = _bf16(*_inputs(200, 200, seed=5))
    want = fa._flash_forward_lse_plain(q, k, v, causal, _SCALE)[0]
    lim = cs._bf16_limit(q, k, v, causal, _SCALE, want)
    shifted = _emulate_normalized(q, k, v.roll(1, 0), causal, _SCALE)[0]
    outside = ((shifted.float() - want.float()).abs() > lim).float().mean()
    assert float(outside) >= 0.5
