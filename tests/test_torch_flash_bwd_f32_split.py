"""The f32 tensor-core flash backward's order of arithmetic, rehearsed on
the CPU against the JAX reference and the port's plain version.

`csrc/flash_attention_bwd.cu::flash_bwd_dq_split3` and
`::flash_bwd_dkv_split3` (dtype code 0) run only on the card. Their
arithmetic is emulated here in torch, step for step:
- every f32 operand x is held as three bf16 terms, hi = bf16(x),
  mid = bf16(x - hi), lo = bf16(x - hi - mid): q * scale (rounded in f32,
  as the reference scales it), k, v, dO, and p and ds;
- each product takes the six cross products whose terms' ranks sum to at
  most 2, smallest first (mid.mid, lo.hi, hi.lo, mid.hi, hi.mid, hi.hi),
  each one 16-deep `mma.sync` step;
- s = (q * scale).k and dp = dO.v: each 16-deep step's six products go to
  a fresh accumulator, which is added to the running f32 sum (round to
  nearest);
- p = exp(s - lse), 0 where masked (64-key tiles, causal at global
  positions), ds = p (dp - dsum), neither rounded;
- dq = scale * ds.k, dk = ds^T.(q * scale), dv = p^T.dO: each 64-deep
  tile's 4 steps x 6 products chain through one fresh accumulator, which
  is added to the running f32 sum once a tile.

A tensor-core step is modelled pessimistically (`_mma`): the 16 exact
products and the accumulator are aligned to the largest exponent among
them, each is truncated toward zero to 24 bits there, and the exact sum is
truncated to f32. Chaining a whole sum through one accumulator would then
lose up to an ulp of the running sum a step, always toward zero; the fresh
accumulators bound that to each chunk's own size.

The emulation is held, at small widths, against the reference's backward
(`mmlspark_tpu.ops.flash_attention._flash_backward`, its Pallas kernels in
interpret mode with 64-row blocks) and against `_flash_backward_plain`,
per element within `flash_attention._bwd_limits` at `_BWD_TOL[float32]`
(2^-21 |want| + 2^-14 r), the card check's own limit: causal and not,
ragged lengths, the ring's (q_offset, k_offset) pairs with lse := m,
dsum := -dl and dO := d_acc, and a causal row that sees one key
(dp = dsum but for rounding). The same limit rejects the emulation with
the hi terms alone at most outputs. Inputs come from seeded numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.flash_attention import _flash_backward
from mmlspark_tpu_torch.ops import flash_attention as fa

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

_TILE, _STEP = 64, 16
# (rank of A's term, rank of B's term): hi 0, mid 1, lo 2; smallest first
_SPLIT3 = ((1, 1), (2, 0), (0, 2), (1, 0), (0, 1), (0, 0))
_HI_ONLY = ((0, 0),)
_H = 2
# (q_offset, k_offset, causal) of one 160-row shard against another: the
# ring's diagonal pair, one off the 64-key grid and a fully visible pair
_PAIRS = {"diagonal": (160, 160, True), "off_grid": (160, 161, True),
          "full": (480, 0, True), "noncausal": (0, 480, False)}


def _split3(x):
    """f32 x -> (hi, mid, lo), bf16 values held in f32; hi + mid + lo == x
    for normal x."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    return hi, mid, (x - hi - mid).bfloat16().float()


def _rz(x):
    """f64 -> f32 rounded toward zero."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _mma(c, a, b):
    """c + a.b over one 16-deep step, a (..., M, 16) and b (..., 16, N)
    bf16 values, c (..., M, N) f32, as the module docstring models a
    tensor-core step."""
    t = torch.cat([a.double().unsqueeze(-1) * b.double().unsqueeze(-3),
                   c.double().unsqueeze(-2)], -2)
    e = torch.frexp(t.abs().amax(-2, keepdim=True)).exponent
    quantum = torch.ldexp(torch.ones_like(t[..., :1, :]), e - 24)
    return _rz((torch.trunc(t / quantum) * quantum).sum(-2))


def _product(a, b, cross, chunk):
    """a (H, M, K) . b (H, K, N) in f32: 16-deep steps over K, each step's
    cross products of the split terms chained through an accumulator that
    starts fresh every `chunk` of K and is then added to the running sum."""
    ta, tb = _split3(a), _split3(b)
    acc = torch.zeros(a.shape[0], a.shape[1], b.shape[2])
    for c0 in range(0, a.shape[2], chunk):
        part = torch.zeros_like(acc)
        for k0 in range(c0, min(c0 + chunk, a.shape[2]), _STEP):
            for i, j in cross:
                part = _mma(part, ta[i][..., k0:k0 + _STEP],
                            tb[j][:, k0:k0 + _STEP])
        acc = acc + part
    return acc


def _emulate(q, k, v, do, lse, dsum, causal, scale, q_offset=0, k_offset=0,
             cross=_SPLIT3):
    """(dq, dk, dv) (S, H, D) f32 in the kernels' order of arithmetic (the
    module docstring) for f32 operands in the public layouts."""
    qs, kh, vh, oh = (t.permute(1, 0, 2) for t in
                      (fa._scaled(q, scale), k, v, do))
    s = _product(qs, kh.transpose(1, 2), cross, _STEP)
    dp = _product(oh, vh.transpose(1, 2), cross, _STEP)
    p = torch.exp(s - lse[:, :, None])
    if causal:
        mask = fa._causal_mask(q.shape[0], k.shape[0], q_offset, k_offset,
                               q.device)
        p = p.masked_fill(mask, 0.0)
    ds = p * (dp - dsum[:, :, None])
    dq = _product(ds, kh, cross, _TILE) * scale
    dk = _product(ds.transpose(1, 2).contiguous(), qs, cross, _TILE)
    dv = _product(p.transpose(1, 2).contiguous(), oh, cross, _TILE)
    return tuple(t.permute(1, 0, 2) for t in (dq, dk, dv))


def _arrays(*shapes, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(size=s).astype(np.float32))
                 for s in shapes)


def _normalized_ops(sq, sk, d, causal, scale, seed):
    """q, k, v, dO and the forward's lse and dsum = rowsum(dO * O), f32."""
    q, k, v, do = _arrays((sq, _H, d), (sk, _H, d), (sk, _H, d),
                          (sq, _H, d), seed=seed)
    out, lse = fa._flash_forward_lse_plain(q, k, v, causal, scale)
    dsum = (do * out).sum(-1).T.contiguous()
    return q, k, v, do, lse, dsum


def _stats_ops(pair, d, scale, seed):
    """The ring pair's operands: lse := m of the stats forward, dsum :=
    -dl and dO := d_acc seeded, and 0 on a row with no visible key (m =
    -1e30), as the ring merge weighs such rows: there the reference's p
    is exp(-1e30 + 1e30) = 1 where the kernels and the plain version take
    0."""
    qo, ko, causal = _PAIRS[pair]
    q, k, v, d_acc = _arrays(*[(160, _H, d)] * 4, seed=seed)
    m = fa._flash_stats_plain(q, k, v, qo, ko, causal, scale)[1]
    live = (m > -1e29).float()
    dsum = -_arrays((_H, 160), seed=seed + 1)[0] * live
    return q, k, v, d_acc * live.T[:, :, None], m, dsum


def _jax_backward(ops, causal, scale, q_offset=0, k_offset=0):
    """The reference's `_flash_backward` (Pallas, interpreted, 64-row
    blocks) on the same operands, as (S, H, D) f32."""
    q, k, v, do, lse, dsum = ops
    qh, kh, vh, gh = (jnp.asarray(t.permute(1, 0, 2).numpy())
                      for t in (q, k, v, do))
    got = _flash_backward(qh, kh, vh, None,
                          jnp.asarray(lse.numpy())[..., None], gh, causal,
                          scale, _TILE, _TILE, True,
                          dsum=jnp.asarray(dsum.numpy())[..., None],
                          q_offset=q_offset, k_offset=k_offset)
    return tuple(torch.as_tensor(np.moveaxis(np.array(g), 0, 1))
                 for g in got)


def _limits_used(got, want, lims):
    """max |got - want| / limit over dq, dk, dv (exact matches count 0)."""
    return [float(torch.where((g - w) == 0, 0.0, (g - w).abs() / lim).max())
            for g, w, lim in zip(got, want, lims)]


def _check(ops, causal, scale, offsets=(0, 0)):
    got = _emulate(*ops, causal, scale, *offsets)
    for want in (_jax_backward(ops, causal, scale, *offsets),
                 fa._flash_backward_plain(*ops, causal, scale, *offsets)):
        lims = fa._bwd_limits(*ops, causal, scale, want, *offsets)
        used = _limits_used(got, want, lims)
        assert max(used) <= 1.0, used
    return got


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(192, 192), (200, 133), (72, 136)])
def test_split3_within_the_f32_limit(sq, sk, causal, d):
    scale = 1.0 / d ** 0.5
    _check(_normalized_ops(sq, sk, d, causal, scale, seed=sq + sk + d),
           causal, scale)


@pytest.mark.parametrize("pair", list(_PAIRS))
def test_split3_on_ring_pairs(pair):
    d, scale = 64, 0.125
    qo, ko, causal = _PAIRS[pair]
    _check(_stats_ops(pair, d, scale, seed=7), causal, scale, (qo, ko))


def test_row_with_one_key():
    """Row 0 of a causal head sees key 0 alone: p = 1 and dsum = dO.v_0,
    so its ds is dp - dsum, two f32 sums that cancel but for rounding.
    Its dq must stay inside the limit as every other row's."""
    d = 64
    scale = 1.0 / d ** 0.5
    ops = _normalized_ops(128, 128, d, True, scale, seed=3)
    dq = _check(ops, True, scale)[0]
    want = fa._flash_backward_plain(*ops, True, scale)
    lim = fa._bwd_limits(*ops, True, scale, want)[0]
    assert float(((dq[0] - want[0][0]).abs() / lim[0]).max()) <= 1.0


@pytest.mark.parametrize("causal", [False, True])
def test_hi_terms_alone_fail_the_limit(causal):
    """Dropping the mid and lo terms costs ~2^-9 relative per product,
    which the f32 limit must reject at most outputs of each gradient."""
    d = 64
    scale = 1.0 / d ** 0.5
    ops = _normalized_ops(192, 192, d, causal, scale, seed=9)
    want = fa._flash_backward_plain(*ops, causal, scale)
    lims = fa._bwd_limits(*ops, causal, scale, want)
    got = _emulate(*ops, causal, scale, cross=_HI_ONLY)
    for g, w, lim in zip(got, want, lims):
        assert float(((g - w).abs() > lim).float().mean()) >= 0.5
