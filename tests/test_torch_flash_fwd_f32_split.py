"""The f32 tensor-core flash forward's order of arithmetic, rehearsed on the
CPU against the JAX reference and the port's plain versions.

`csrc/flash_attention.cu::flash_fwd_split3` (dtype code 0, both forms) runs
only on the card. Its arithmetic is emulated here in torch, step for step,
with the pessimistic tensor-core model of
tests/test_torch_flash_bwd_f32_split.py (`_mma`: each 16-deep step's
products and accumulator aligned to the largest exponent among them,
truncated toward zero to 24 bits there, the sum truncated to f32):
- every f32 operand x is held as three bf16 terms, hi = bf16(x),
  mid = bf16(x - hi), lo = bf16(x - hi - mid): q * scale (rounded in f32,
  as the reference scales it), K, V and the unrounded p;
- each product takes the six cross products whose terms' ranks sum to at
  most 2, smallest first;
- key tiles of `_TILE` keys (the kernel's kBKS), causal masking at global
  offsets, the -1e30 mask, and 0 in place of the running max while a row
  has no visible key (its masked p are then exp(-1e30) = 0);
- s = (q * scale).K^T: each 16-deep step's six products in a fresh
  accumulator, added to s in f32;
- online softmax in f32: alpha = exp(m_old - m_new), p = exp(s - m), l
  sums the unrounded p;
- O = fma(O, alpha, P.V), the tile's P.V (2 steps x 6 products) chained
  through one fresh accumulator;
- normalized: out = O / max(l, 1e-30), lse = m + log(max(l, 1e-30));
  stats: acc = O, m, l.

The emulation is held, at small widths (H=2, D in {16, 64}, ragged
lengths of 160-200), within the card check's own limits
(`chip_smoke._FLASH_F32_TOL` for out and acc / l, `_LSE_TOL` for lse and
m), against the reference's `_flash_forward_lse` and
`flash_attention_stats` (Pallas in interpret mode, 64-key blocks, as the
JAX tests run them) and against `_flash_forward_lse_plain` /
`_flash_stats_plain` (through `chip_smoke._stats_check`, which also demands
that a row with no visible key ends acc = 0, l = 0, m = -1e30): causal
and not, and the ring's (q_offset, k_offset) pairs on and off the key
grid. The same limit rejects the emulation with the hi terms alone at most
outputs. Inputs come from seeded numpy.
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
from test_torch_flash_bwd_f32_split import (_HI_ONLY, _SPLIT3, _STEP,
                                            _product)

_TILE = 32        # keys per tile of flash_fwd_split3 (kBKS)
_JAX_BLOCK = 64   # the reference's blocks
_MASK = -1e30
_H = 2
# (q_offset, k_offset, causal) of one 160-row shard against another: the
# ring's diagonal pair, one key off the grid (rows with no visible key in a
# computed tile), fully visible, fully masked and non-causal
_PAIRS = {"diagonal": (160, 160, True), "off_grid": (160, 161, True),
          "full": (480, 0, True), "masked": (0, 480, True),
          "noncausal": (0, 480, False)}


def _inputs(sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(s, _H, d)).astype(np.float32)
                 for s in (sq, sk, sk))


def _fma(a, b, c):
    """a * b + c in f32 with one rounding (the f64 product is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _emulate(q, k, v, causal, scale, q_offset=0, k_offset=0,
             cross=_SPLIT3):
    """(acc (Sq, H, D), m (H, Sq), l (H, Sq)), all f32, of f32 q, k, v in
    the kernel's order of arithmetic (the module docstring). A tile the
    kernel skips (every key after every row of its block) changes nothing
    here: its p are 0 and its max leaves m as it is."""
    sq, sk, d = q.shape[0], k.shape[0], q.shape[2]
    qs = fa._scaled(q, scale).permute(1, 0, 2)          # (H, Sq, D)
    m = torch.full((_H, sq), _MASK)
    l = torch.zeros(_H, sq)
    acc = torch.zeros(_H, sq, d)
    q_pos = torch.arange(sq)[:, None] + q_offset
    for k0 in range(0, sk, _TILE):
        kt = k[k0:k0 + _TILE].permute(1, 2, 0)           # (H, D, keys)
        vt = v[k0:k0 + _TILE].permute(1, 0, 2)           # (H, keys, D)
        s = _product(qs, kt, cross, _STEP)
        if causal:
            k_pos = torch.arange(k0, k0 + kt.shape[2])[None, :] + k_offset
            s = s.masked_fill(q_pos < k_pos, _MASK)
        mn = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - mn)
        p = torch.exp(s - torch.where(mn == _MASK, 0.0, mn)[..., None])
        l = l * alpha + p.sum(-1)
        acc = _fma(acc, alpha[..., None],
                   _product(p, vt, cross, _TILE))
        m = mn
    return acc.permute(1, 0, 2).contiguous(), m, l


def _emulate_normalized(q, k, v, causal, scale, cross=_SPLIT3):
    acc, m, l = _emulate(q, k, v, causal, scale, cross=cross)
    den = l.clamp_min(1e-30)
    return acc / den.T[:, :, None], m + den.log()


def _f32_limit(want):
    rtol, atol = cs._FLASH_F32_TOL
    return atol + rtol * want.abs()


def _lse_used(got, want):
    return cs._limit_used(got, want, cs._LSE_TOL[1]
                          + cs._LSE_TOL[0] * want.abs())


def _jax_normalized(q, k, v, causal, scale):
    """The reference's out (Sq, H, D) and lse (H, Sq), 64-key blocks."""
    out, lse = _flash_forward_lse(
        *(jnp.moveaxis(jnp.asarray(a), 1, 0) for a in (q, k, v)), causal,
        scale, _JAX_BLOCK, _JAX_BLOCK, True)
    return (torch.as_tensor(np.moveaxis(np.array(out), 0, 1)),
            torch.as_tensor(np.array(lse)[..., 0]))


@pytest.mark.parametrize("reference", ["jax", "plain"])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(200, 200), (168, 192)])
def test_split3_within_the_f32_limit(sq, sk, causal, d, reference):
    arrays = _inputs(sq, sk, d, seed=sq + sk + d)
    q, k, v = (torch.as_tensor(a) for a in arrays)
    scale = 1.0 / d ** 0.5
    got, got_lse = _emulate_normalized(q, k, v, causal, scale)
    if reference == "jax":
        want, want_lse = _jax_normalized(*arrays, causal, scale)
    else:
        want, want_lse = fa._flash_forward_lse_plain(q, k, v, causal, scale)
    assert cs._limit_used(got, want, _f32_limit(want)) <= 1.0
    assert _lse_used(got_lse, want_lse) <= 1.0


def _stats_inputs(d=64):
    return tuple(torch.as_tensor(a) for a in _inputs(160, 160, d, seed=3))


@pytest.mark.parametrize("pair", list(_PAIRS))
def test_split3_stats_match_jax_on_live_rows(pair):
    """Against the reference's stats form on the rows with a visible key
    (the reference leaves the others garbage, flagged by m = -1e30)."""
    q, k, v = _stats_inputs()
    qo, ko, causal = _PAIRS[pair]
    scale = 0.125
    acc, m, l = _emulate(q, k, v, causal, scale, qo, ko)
    w_acc, w_m, w_l = (torch.as_tensor(np.array(x, np.float32)) for x in
                       jax_stats(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                 qo, ko, causal, scale, _JAX_BLOCK,
                                 _JAX_BLOCK, True))
    live = w_m > -1e29
    assert torch.equal(m > -1e29, live)
    if not bool(live.any()):
        return
    out = (acc / l.clamp_min(1e-30).T[:, :, None])[live.T]
    w_out = (w_acc / w_l.clamp_min(1e-30).T[:, :, None])[live.T]
    assert cs._limit_used(out, w_out, _f32_limit(w_out)) <= 1.0
    assert _lse_used(m[live], w_m[live]) <= 1.0
    assert _lse_used((m + l.log())[live], (w_m + w_l.log())[live]) <= 1.0


@pytest.mark.parametrize("pair", list(_PAIRS))
def test_split3_stats_pass_the_card_check_against_plain(pair):
    """`chip_smoke._stats_check`, the card check itself: rows with no
    visible key exactly acc = 0, l = 0, m = -1e30 (off the key grid too),
    live rows within the limits."""
    q, k, v = _stats_inputs()
    qo, ko, causal = _PAIRS[pair]
    got = _emulate(q, k, v, causal, 0.125, qo, ko)
    want = fa._flash_stats_plain(q, k, v, qo, ko, causal, 0.125)
    res = cs._stats_check(got, want, q, k, v, qo, ko, causal, 0.125)
    assert max(res["m"], res["lse"], res["out"]) <= 1.0, res
    if pair == "off_grid":
        # row 0 sees no key: its only computed tile masks all of them
        assert bool((got[1][:, 0] == _MASK).all())
        assert bool((got[0][0] == 0).all() and (got[2][:, 0] == 0).all())


@pytest.mark.parametrize("causal", [False, True])
def test_hi_terms_alone_fail_the_limit(causal):
    """Dropping the mid and lo terms costs ~2^-9 relative per product,
    which the f32 limit must reject at most outputs."""
    q, k, v = (torch.as_tensor(a) for a in _inputs(200, 200, 64, seed=9))
    want = fa._flash_forward_lse_plain(q, k, v, causal, 0.125)[0]
    got = _emulate_normalized(q, k, v, causal, 0.125, cross=_HI_ONLY)[0]
    outside = ((got - want).abs() > _f32_limit(want)).float().mean()
    assert float(outside) >= 0.5
