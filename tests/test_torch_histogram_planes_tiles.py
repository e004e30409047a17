"""The tensor-core planes kernel's launch and arithmetic, on the CPU.

`csrc/histogram.cu::hist_planes_kernel` runs only on the card. Its launch
is planned in Python (`histogram_cuda.plan_planes`, no card needed) and
its arithmetic is emulated here in numpy and torch, at the level of the
kernel's fragments:
- a block owns fg features of the plan's feature groups and the tiles of
  64 rows its row block takes (tile rb, rb + row_blocks, ...);
- the tile's hi bytes come from the kernel's byte operations: four rows'
  bins words transposed by `prmt`, hi = node * W + bin / LO per byte,
  0x40 set for a row that adds nothing (inactive, node outside [0, m),
  past n, or bin >= B), every byte below 0x80;
- U^T, the B operand of `mma.sync.m16n8k16`, is built per lane (g, q):
  the rows 2q, 2q+1, 2q+8, 2q+9 of a 16-row step compared bytewise with
  h = 8 ht + g ((hi ^ h) + 0x7f has bit 7 set where they differ), the
  mismatch masks spread to 16-bit halves by `prmt`'s sign replication and
  cleared from the rows' packed bf16 stats;
- A is the plan's 16 x 16 tile as `ldmatrix.trans` hands it out (int8
  pairs as b16: rows 2q, 2q+1 at lo 2g, 2g+1), each int8 pair turned into
  bf16 by the kernel's integer/bf16 sequence, M permuted so that M = g is
  lo 2g and M = g + 8 is lo 2g + 1;
- each tile's four 16-row steps chain through a fresh accumulator
  (`_mma`, the pessimistic tensor-core model of
  test_torch_flash_bwd_f32_split.py: accumulator input truncated toward
  zero), the tile's sum is added to the warp's f32 totals, and the
  blocks' totals are added into the output.

The emulation is held against the port's plain version `_torch_hist_planes`
and against the reference's planes kernel (`pallas_hist` with the planes
route, in interpret mode) on the same seeded inputs: counts exactly, grad
and hess within `chip_smoke._HIST_RTOL_OF_ABS_SUM` of the sum of |stat|
per bin, the card check's own limit. A plan of the bins shifted by one
row fails that check. Plan values other than 0/1 (2, -1, -128, 127) are
held against `_torch_hist_planes`, which multiplies by them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mmlspark_tpu.ops import histogram_pallas as hp
from mmlspark_tpu_torch.ops import histogram as port
from mmlspark_tpu_torch.ops import histogram_cuda as hc
from test_torch_flash_bwd_f32_split import _mma

# one torch intra-op thread: the suite runs in several xdist workers, and
# each worker's torch would otherwise start a thread per core
torch.set_num_threads(1)

# the H100's shared memory (opt-in per block, per SM) and SM count; a
# small card (2 SMs) gives each block several tiles
_PER_BLOCK, _PER_SM = 232_448, 233_472
_ROWS = hc.PLANES_ROWS


def _prmt(a, b, sel):
    """prmt.b32 on uint32 arrays: byte i of the result is byte s & 7 of
    (a: bytes 0-3, b: bytes 4-7), or its top bit replicated if s & 8, for
    s the i-th nibble of `sel`."""
    src = [(a >> np.uint32(8 * i)) & np.uint32(0xff) for i in range(4)] + \
        [(b >> np.uint32(8 * i)) & np.uint32(0xff) for i in range(4)]
    out = np.zeros(np.broadcast(a, b).shape, np.uint32)
    for i in range(4):
        s = (sel >> (4 * i)) & 0xf
        v = src[s & 7]
        if s & 8:
            v = np.where(v & np.uint32(0x80), np.uint32(0xff), np.uint32(0))
        out |= v.astype(np.uint32) << np.uint32(8 * i)
    return out


def _halves(w):
    """uint32 bf16x2 words -> (lower, upper) halves as float32 values."""
    lo = (w & np.uint32(0xffff)) << np.uint32(16)
    hi = w & np.uint32(0xffff0000)
    return lo.view(np.float32), hi.view(np.float32)


def _pack_bf16(x, y):
    """bf16(x) in the lower half, bf16(y) in the upper (round to nearest
    even), as the kernel's __floats2bfloat162_rn."""
    def bits(v):
        return torch.as_tensor(v).to(torch.bfloat16).view(torch.int16) \
            .numpy().astype(np.uint16).astype(np.uint32)
    return bits(x) | (bits(y) << np.uint32(16))


def _int8x2_to_bf16x2(w):
    """Bytes 0 and 2 of w as the bf16 values of their int8 contents: p is
    bf16 128 + (b & 127), q is -128 or -256; p + q is exact."""
    p = (w & np.uint32(0x007f007f)) | np.uint32(0x43004300)
    q = (w & np.uint32(0x00800080)) | np.uint32(0xc300c300)
    (p0, p1), (q0, q1) = _halves(p), _halves(q)
    return p0 + q0, p1 + q1


def _tile_tables(bins, node, stats, r0, rows, f0, words, m, w, lo):
    """The tile's hi words hi4[step, q, fl] (byte e = row 2q, 2q+1, 2q+8,
    2q+9 [e] of the step, 0x40 set where the row adds nothing) and packed
    stats st[step, q, 2s + {0, 1}]."""
    n, f = bins.shape
    ge = np.uint32((0x40 - w) * 0x01010101)
    low = np.uint32(0x0f0f0f0f if lo == 16 else 0x03030303)
    shift = np.uint32(4 if lo == 16 else 6)
    hi4 = np.zeros((_ROWS // 16, 4, 4 * words), np.uint32)
    st = np.zeros((_ROWS // 16, 4, 6), np.uint32)
    for step in range(_ROWS // 16):
        for q in range(4):
            rr = [16 * step + 2 * q + (e & 1) + 8 * (e >> 1)
                  for e in range(4)]
            nw = np.uint32(0)
            for e, r in enumerate(rr):
                ok = r < rows and 0 <= node[r0 + r] < m
                nw |= np.uint32(node[r0 + r] * w if ok else 0x40) \
                    << np.uint32(8 * e)
            for j in range(words):
                wd = []
                for r in rr:
                    b4 = np.zeros(4, np.uint8)
                    if r < rows:
                        cols = bins[r0 + r, f0 + 4 * j:f0 + 4 * j + 4]
                        b4[:len(cols)] = cols
                    wd.append(b4.view(np.uint32)[0])
                t0, t1 = _prmt(wd[0], wd[1], 0x5140), \
                    _prmt(wd[0], wd[1], 0x7362)
                t2, t3 = _prmt(wd[2], wd[3], 0x5140), \
                    _prmt(wd[2], wd[3], 0x7362)
                fw = [_prmt(t0, t2, 0x5410), _prmt(t0, t2, 0x7632),
                      _prmt(t1, t3, 0x5410), _prmt(t1, t3, 0x7632)]
                for k in range(4):
                    x = (fw[k] >> shift) & low
                    hi4[step, q, 4 * j + k] = (x + nw) | \
                        ((x + ge) & np.uint32(0x40404040))
            sv = [[stats[s][r0 + r] if r < rows else np.float32(0)
                   for r in rr] for s in range(3)]
            for s in range(3):
                st[step, q, 2 * s] = _pack_bf16(sv[s][0], sv[s][1])
                st[step, q, 2 * s + 1] = _pack_bf16(sv[s][2], sv[s][3])
    return hi4, st


def _u_t(hi4, st, ht_n):
    """U^T (steps, F_loc, 16 rows, 3 x ht_n x 8) from the lanes' B
    fragments: column (s * ht_n + ht) * 8 + g is stat s where the row's hi
    is 8 ht + g."""
    steps, _, fw = hi4.shape
    out = np.zeros((steps, fw, 16, 3 * ht_n * 8), np.float32)
    g = np.arange(8, dtype=np.uint32)
    for q in range(4):
        h4 = hi4[:, q, :, None]                              # (step, f, 1)
        for ht in range(ht_n):
            ne = (h4 ^ ((np.uint32(8 * ht) + g) * np.uint32(0x01010101))) \
                + np.uint32(0x7f7f7f7f)
            m0, m1 = _prmt(ne, ne, 0x9988), _prmt(ne, ne, 0xbbaa)
            for s in range(3):
                col = (s * ht_n + ht) * 8 + np.arange(8)
                for j, (b0, b1) in enumerate(zip(
                        _halves(st[:, q, None, 2 * s, None] & ~m0),
                        _halves(st[:, q, None, 2 * s + 1, None] & ~m1))):
                    out[:, :, 2 * q + j, col] = b0
                    out[:, :, 2 * q + 8 + j, col] = b1
    return out


def _a_tiles(plan_tile, lo):
    """A (steps, F_loc, C chunks, 16 M, 16 K) from the plan tile (F_loc,
    rows, LO) int8 as `ldmatrix.trans` hands it to lane (g, q): rows 2q,
    2q+1 (+8) at lo 16t + 2g, 16t + 2g + 1, turned to bf16 pairs."""
    fl, _, _ = plan_tile.shape
    c_n = lo // 16
    out = np.zeros((_ROWS // 16, fl, c_n, 16, 16), np.float32)
    u = plan_tile.view(np.uint8).astype(np.uint32)
    for step in range(_ROWS // 16):
        for half in range(2):
            for q in range(4):
                r = 16 * step + 8 * half + 2 * q
                for t in range(c_n):
                    for g in range(8):
                        c = 16 * t + 2 * g
                        word = (u[:, r, c] | (u[:, r, c + 1] << 8)
                                | (u[:, r + 1, c] << 16)
                                | (u[:, r + 1, c + 1] << 24))
                        for mrow, wd in ((g, word), (g + 8, word >> 8)):
                            k0, k1 = _int8x2_to_bf16x2(wd)
                            kk = 8 * half + 2 * q
                            out[step, :, t, mrow, kk] = k0
                            out[step, :, t, mrow, kk + 1] = k1
    return out


def _emulate_planes(bins, grad, hess, node, m, b, count_w, plan, geo):
    """The planes kernel's result (m, F, B) x 3 at launch `geo`, built as
    the module docstring says. `node` is -1 for inactive rows."""
    n, f = bins.shape
    lo = plan.shape[2]
    w, c_n = b // lo, lo // 16
    n_hi = m * w
    cnt = np.ones(n, np.float32) if count_w is None else count_w
    stats = (grad, hess, cnt)
    out = np.zeros((3, m, f, b), np.float32)
    n_tiles = -(-n // _ROWS)
    for grp in range(geo.groups):
        f0 = grp * geo.fg
        nf = min(geo.fg, f - f0)
        for rb in range(geo.row_blocks):
            tot = torch.zeros(nf, c_n, 16, 3 * geo.ht * 8)
            for tile in range(rb, n_tiles, geo.row_blocks):
                r0 = tile * _ROWS
                rows = min(_ROWS, n - r0)
                hi4, st = _tile_tables(bins, node, stats, r0, rows, f0,
                                       geo.fg // 4, m, w, lo)
                ut = torch.as_tensor(_u_t(hi4[:, :, :nf], st, geo.ht))
                ptile = np.zeros((nf, _ROWS, lo), np.int8)
                ptile[:, :rows] = plan[f0:f0 + nf, r0:r0 + rows]
                a = torch.as_tensor(_a_tiles(ptile, lo))
                d = torch.zeros_like(tot)             # fresh each tile
                for step in range(_ROWS // 16):
                    d = _mma(d, a[step], ut[step][:, None])
                tot = tot + d
            for t in range(c_n):
                for mm in range(16):
                    lo_i = 16 * t + 2 * (mm % 8) + mm // 8
                    for s in range(3):
                        for h in range(n_hi):
                            ht, g = divmod(h, 8)
                            col = (s * geo.ht + ht) * 8 + g
                            nd, hw = divmod(h, w)
                            out[s, nd, f0:f0 + nf, hw * lo + lo_i] += \
                                tot[:, t, mm, col].numpy()
    return tuple(torch.as_tensor(x) for x in out)


def _data(n, f, m, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, b, size=(n, f)).astype(np.uint8),
            rng.normal(size=n).astype(np.float32),
            rng.uniform(0.1, 1, size=n).astype(np.float32),
            rng.integers(-1, m, size=n).astype(np.int32),
            rng.integers(0, 2, size=n).astype(np.float32))


def _check(got, want, abs_grad, abs_hess):
    """Counts exact; grad/hess within the card check's limit."""
    assert torch.equal(got[2], want[2])
    for g, w, scale in ((got[0], want[0], abs_grad),
                        (got[1], want[1], abs_hess)):
        lim = cs._HIST_RTOL_OF_ABS_SUM * scale + 1e-6
        assert bool(((g - w).abs() <= lim).all()), \
            float((g - w).abs().max())


def _geo(n, f, m, b, sms=2):
    return hc.plan_planes(n, f, m, b, port.plan_lo_bins(b), _PER_BLOCK,
                          _PER_SM, sms)


def _bf16(x):
    return torch.as_tensor(x).to(torch.bfloat16).to(torch.float32)


_CASES = [  # (n, F, m, B, count_w): ragged last tile, F past one feature
    # group, F % 4 != 0, n below one 16-row step, B = 96 and 256 (LO = 64)
    (1000, 36, 2, 64, True),
    (700, 6, 4, 64, False),
    (10, 3, 1, 64, True),
    (500, 5, 4, 96, True),
    (300, 7, 4, 256, False),
]


def _emulate_and_plain(n, f, m, b, with_cw):
    """(emulation, `_torch_hist_planes`, the limit scales, the inputs) on
    seeded inputs."""
    bins, grad, hess, node, cw = _data(n, f, m, b, seed=n + f + m + b)
    count_w = cw if with_cw else None
    t = torch.as_tensor
    plan = port.build_hist_plan(t(bins), b)
    got = _emulate_planes(bins, grad, hess, node, m, b, count_w,
                          plan.numpy(), _geo(n, f, m, b))
    args = (t(bins), t(grad), t(hess), t(node), t(node >= 0), m, b)
    want = port._torch_hist_planes(
        *args, count_w=None if count_w is None else t(count_w),
        lo_planes=plan, plane_lo=port.plan_lo_bins(b))
    scales = [port._torch_hist(args[0], _bf16(s).abs(), *args[2:])[0]
              for s in (grad, hess)]
    return got, want, scales, (bins, grad, hess, node, count_w)


@pytest.mark.parametrize("n,f,m,b,with_cw", _CASES)
def test_emulation_matches_plain(n, f, m, b, with_cw):
    got, want, scales, _ = _emulate_and_plain(n, f, m, b, with_cw)
    _check(got, want, *scales)


@pytest.mark.parametrize("n,f,m,b,with_cw", [(700, 6, 4, 64, True),
                                             (300, 7, 3, 256, False)])
def test_emulation_matches_reference_kernel(n, f, m, b, with_cw):
    """The reference's planes kernel in interpret mode (the JAX tests'
    way of running it on the CPU), one case per digit width."""
    got, _, scales, (bins, grad, hess, node, cw) = _emulate_and_plain(
        n, f, m, b, with_cw)
    j = jnp.asarray
    ref = hp.pallas_hist(j(bins), j(grad), j(hess), j(node), j(node >= 0),
                         m, b, count_w=None if cw is None else j(cw),
                         lo_planes=hp.build_hist_plan(j(bins), b),
                         plane_lo=port.plan_lo_bins(b), interpret=True)
    _check(got, tuple(torch.tensor(np.asarray(x)) for x in ref), *scales)


def test_plan_values_are_factors():
    """Plan bytes 2, -1, -128 and 127 enter as those factors, as the
    plain version multiplies by them; rows past B and nodes past m still
    add nothing."""
    n, f, m, b = 400, 6, 3, 64
    bins, grad, hess, node, cw = _data(n, f, m, b, seed=7)
    rng = np.random.default_rng(8)
    out = rng.random((n, f)) < 0.1                       # bins >= B
    bins[out] = rng.integers(b, 256, size=int(out.sum()))
    node[rng.random(n) < 0.1] = m + 1                    # past the last
    t = torch.as_tensor
    plan = port.build_hist_plan(t(bins), b)
    r = t(rng.random(plan.shape))
    plan[(plan == 1) & (r < 0.3)] = 2
    plan[(plan == 0) & (r < 0.03)] = -1
    plan[(plan == 0) & (r > 0.99)] = -128
    plan[(plan == 0) & (r > 0.98) & (r <= 0.99)] = 127
    got = _emulate_planes(bins, grad, hess, node, m, b, cw, plan.numpy(),
                          _geo(n, f, m, b))
    want = port._torch_hist_planes(t(bins), t(grad), t(hess), t(node),
                                   t(node >= 0), m, b, count_w=t(cw),
                                   lo_planes=plan, plane_lo=16)
    # the limit scale: the sum of |stat x plan value| per bin
    mag = torch.where(plan == -128, 127, plan.abs()).to(torch.int8)
    scales = port._torch_hist_planes(
        t(bins), t(grad).abs(), t(hess), t(node), t(node >= 0), m, b,
        lo_planes=mag, plane_lo=16)[:2]
    _check(got, want, *scales)


def test_shifted_plan_fails_the_check():
    """The emulation reads lo from the plan: on a plan of the bins
    shifted by one row it fails the check it passes on the right plan."""
    n, f, m, b = 600, 4, 2, 64
    bins, grad, hess, node, _ = _data(n, f, m, b, seed=9)
    t = torch.as_tensor
    args = (t(bins), t(grad), t(hess), t(node), t(node >= 0), m, b)
    want = port._torch_hist_planes(
        *args, lo_planes=port.build_hist_plan(t(bins), b), plane_lo=16)
    shifted = port.build_hist_plan(t(np.roll(bins, 1, 0)), b)
    got = _emulate_planes(bins, grad, hess, node, m, b, None,
                          shifted.numpy(), _geo(n, f, m, b))
    with pytest.raises(AssertionError):
        _check(got, want, *[port._torch_hist(
            t(bins), _bf16(s).abs(), t(hess), t(node), t(node >= 0), m,
            b)[0] for s in (grad, hess)])


@pytest.mark.parametrize("b", [64, 80, 96, 112, 128, 192, 256])
def test_planner_launches(b):
    """Every feature in one group, a multiple of 4 features a block, items
    (feature x lo chunk) within the block's 8 warps, shared memory within
    the H100's and the formula the kernel uses; levels past the kernel's
    hi digits are refused."""
    lo = port.plan_lo_bins(b)
    for m in range(1, 9):
        for f in (1, 5, 32, 137):
            for n in (10, 8_000_000):
                n_hi = m * b // lo
                if n_hi > (32 if lo == 16 else 16):
                    with pytest.raises(ValueError, match="hi digits"):
                        _geo(n, f, m, b, 132)
                    continue
                geo = _geo(n, f, m, b, 132)
                assert geo.ht == -(-n_hi // 8)
                assert geo.fg % 4 == 0 and geo.groups * geo.fg >= f
                assert (geo.groups - 1) * geo.fg < f
                assert geo.fg * lo // 16 <= hc.PLANES_WARPS * \
                    hc.planes_items_per_warp(geo.ht)
                assert geo.smem == hc.planes_smem(f, lo, geo.fg)
                assert geo.smem <= _PER_BLOCK
                assert 1 <= geo.row_blocks <= -(-n // _ROWS)
    # the headline's levels: all 32 features in one group at m <= 2
    for m, groups in ((1, 1), (2, 1), (4, 2)):
        assert _geo(8_000_000, 32, m, 64, 132).groups == groups
