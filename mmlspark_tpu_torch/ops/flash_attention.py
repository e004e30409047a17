"""Exact attention without the (S, S) score matrix: the flash forward and
its backward.

Port of `mmlspark_tpu/ops/flash_attention.py`. The public layout is the
reference's: q (Sq, H, D), k/v (Sk, H, D), out (Sq, H, D) in q's dtype;
Sk may differ from Sq, and causal masking compares raw positions
(`q_pos >= k_pos`, top-left aligned when Sq != Sk).

The tensor's device chooses the path: a CPU tensor takes the plain
versions (`_flash_forward_lse_plain`, `_flash_backward_plain`: dense f32
scores with the reference's semantics and rounding points); a CUDA tensor
launches the hand-written kernels in `csrc/flash_attention.cu` (forward)
and `csrc/flash_attention_bwd.cu` (the dq and dk/dv kernels), with D in
{16, 32, 64, 128}, or raises. Nothing falls back. bf16 runs on the tensor
cores; so does the f32 backward, each f32 operand split into three bf16
terms; the f32 forward runs on the CUDA cores.

`flash_attention` is differentiable: its forward saves q, k, v, out and
lse (the reference's residuals), and its backward computes
dsum = rowsum(dO * O) in f32 and runs the two backward kernels, which
rebuild p = exp(s - lse) tile by tile, so training memory stays free of
(S, S) buffers too.

`flash_attention_stats` is ring attention's partial attention for one
(q shard, kv shard) pair at global offsets: the unnormalized f32
accumulator and the (m, l) carry, from the forward kernel's stats form
(plain version `_flash_stats_plain`). Its backward is the same two
backward kernels with lse := m, dsum := -dl and dO := d_acc at the pair's
offsets (`_FlashStats`), exact for shift-invariant consumers such as the
ring merge.

The reference's `block_q`/`block_k` (v5e VMEM tiling) and `interpret`
(Pallas interpret mode) have no meaning here: the kernels use their own
64 x 64 tiles, so both entry points reject them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# launches of the kernel, counted where the wrapper launches it (and
# nowhere else) so a run can show that its path went through the kernel
launches = {"flash_fwd": 0, "flash_stats_fwd": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}

HEAD_DIMS = (16, 32, 64, 128)     # the kernel's instantiations
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MASK = -1e30                     # the reference's mask value, not -inf

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_lib = None
_bwd_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.flash_fwd_launch.argtypes = (
            [_P] * 5 + [ctypes.c_int] * 5 + [_I64] * 8
            + [ctypes.c_float, ctypes.c_int, _P])
        lib.flash_fwd_launch.restype = ctypes.c_int
        lib.flash_stats_fwd_launch.argtypes = (
            [_P] * 6 + [ctypes.c_int] * 5 + [_I64] * 8
            + [ctypes.c_float] + [ctypes.c_int] * 3 + [_P])
        lib.flash_stats_fwd_launch.restype = ctypes.c_int
        lib.flash_fwd_occupancy.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)] * 3
        lib.flash_fwd_occupancy.restype = ctypes.c_int
        _lib = lib
    return _lib


def _bwd_library():
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load("flash_attention_bwd")
        common = [ctypes.c_int] * 5 + [ctypes.POINTER(_I64), ctypes.c_float,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, _P]
        lib.flash_bwd_dq_launch.argtypes = [_P] * 7 + common
        lib.flash_bwd_dkv_launch.argtypes = [_P] * 8 + common
        lib.flash_bwd_dq_launch.restype = ctypes.c_int
        lib.flash_bwd_dkv_launch.restype = ctypes.c_int
        lib.flash_bwd_occupancy.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)] * 2
        lib.flash_bwd_occupancy.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


def flash_fwd_occupancy(normalized: bool, dtype_code: int, d: int):
    """(registers per thread, dynamic shared memory per block in bytes,
    blocks per SM) of the forward kernel, normalized or stats form, for a
    dtype code (0 f32, 1 bf16) and head dim, on the current card."""
    regs, smem, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _library().flash_fwd_occupancy(
        int(normalized), dtype_code, d, ctypes.byref(regs),
        ctypes.byref(smem), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"flash_fwd_occupancy failed: cudaError_t {err}")
    return regs.value, smem.value, blocks.value


def flash_bwd_occupancy(kernel: str, dtype_code: int, d: int):
    """(dynamic shared memory per block in bytes, blocks per SM) of the
    backward kernel "dq" or "dkv" for a dtype code (0 f32, 1 bf16, 2 bf16
    with an f32 dO) and head dim, on the current card."""
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    err = _bwd_library().flash_bwd_occupancy(
        int(kernel == "dq"), dtype_code, d, ctypes.byref(smem),
        ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"flash_bwd_occupancy failed: cudaError_t {err}")
    return smem.value, blocks.value


def _scaled(q, scale: float):
    """q * scale rounded in q's own dtype, as the reference scales it
    (`q_ref[0] * jnp.asarray(scale, q.dtype)`): for bf16 the scale is
    rounded to bf16 first and the product rounded again."""
    return q * torch.tensor(scale, dtype=q.dtype, device=q.device)


def _flash_forward_lse_plain(q, k, v, causal: bool, scale: float):
    """Plain version: dense f32 scores, the reference's -1e30 mask on raw
    positions, p rounded to v's dtype before the PV product.

    q (Sq, H, D), k/v (Sk, H, D) -> out (Sq, H, D) in q's dtype and
    lse (H, Sq) f32 = m + log(max(l, 1e-30)). (The reference's
    `_flash_forward_lse` takes the per-head (H, S, D) layout and returns
    lse as (H, S, 1).)"""
    s = torch.einsum("qhd,khd->hqk", _scaled(q, scale).float(), k.float())
    if causal:
        q_pos = torch.arange(q.shape[0], device=q.device)[:, None]
        k_pos = torch.arange(k.shape[0], device=q.device)[None, :]
        s.masked_fill_(q_pos < k_pos, _MASK)
    m = s.amax(-1, keepdim=True)
    p = s.sub_(m).exp_()            # in place: one (H, Sq, Sk) f32 buffer
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("hqk,khd->hqd", p.to(v.dtype).float(), v.float())
    den = l.clamp_min(1e-30)
    out = (acc / den).to(q.dtype).permute(1, 0, 2).contiguous()
    return out, (m + den.log())[..., 0]


def _causal_mask(sq, sk, q_offset, k_offset, device):
    """(Sq, Sk) bool, True where the key is after the query in global
    positions (q_offset + i < k_offset + j): the entries causal masks."""
    return (torch.arange(sq, device=device)[:, None] + (q_offset - k_offset)
            < torch.arange(sk, device=device)[None, :])


def _flash_stats_plain(q, k, v, q_offset: int, k_offset: int, causal: bool,
                       scale: float):
    """Plain version of the stats form: dense f32 scores at global
    positions, the reference's -1e30 mask and rounding points (q scaled in
    its own dtype, p rounded to v's dtype before the PV product, l summing
    the unrounded p).

    q (Sq, H, D), k/v (Sk, H, D) -> acc (Sq, H, D) f32 unnormalized, m and
    l (H, Sq) f32. p is zeroed where masked, which is what the kernel
    computes wherever it computes a tile (there a masked entry of a row
    with a visible key is exp(-1e30 - m) = 0) and where it skips one: a row
    with no visible key comes out acc = 0, l = 0, m = -1e30 (Queue 3 (c):
    the reference leaves such rows garbage, flagged by that m)."""
    s = torch.einsum("qhd,khd->hqk", _scaled(q, scale).float(), k.float())
    mask = None
    if causal:
        mask = _causal_mask(q.shape[0], k.shape[0], q_offset, k_offset,
                            q.device)
        s.masked_fill_(mask, _MASK)
    m = s.amax(-1)
    p = s.sub_(m[..., None]).exp_()  # in place: one (H, Sq, Sk) buffer
    if mask is not None:
        p.masked_fill_(mask, 0.0)
    l = p.sum(-1)
    acc = torch.einsum("hqk,khd->qhd", p.to(v.dtype).float(), v.float())
    return acc, m, l


def _bf16_rounding_scale(q, k, v, causal: bool, scale: float,
                         q_offset: int = 0, k_offset: int = 0):
    """sqrt(sum_j p_j^2 v_j^2) / sum_j p_j for each output element (Sq, H, D)
    f32, with p_j the row's softmax weights (causal at the given global
    offsets; 0 on a row with no visible key).

    Rounding each p_j with a relative error e_j moves that output by
    sum_j p_j e_j v_j / sum_j p_j, whose standard deviation is this scale
    times the std of e: what a bf16 check must allow for where two
    versions round p at different points. Computed with the plain stats
    version on f32 copies: doubling the scale doubles every f32 score
    exactly, so the stats of v^2 under doubled scores give
    sum_j p_j^2 v_j^2 directly as their accumulator, over l^2."""
    q, k, v = (t.float() for t in (q, k, v))
    l = _flash_stats_plain(q, k, v, q_offset, k_offset, causal, scale)[2]
    acc2 = _flash_stats_plain(q, k, v * v, q_offset, k_offset, causal,
                              2 * scale)[0]
    return acc2.sqrt_() / l.clamp_min(1e-30).T[:, :, None]


def _bwd_tiles(q, k, v, do, lse, causal: bool, scale: float,
               q_offset: int = 0, k_offset: int = 0):
    """Per head hh: (hh, p, dp) as (Sq, Sk) f32: p = exp(s - lse) with s
    from q scaled in its own dtype and the -1e30 mask at global positions,
    dp = dO.v^T (the reference's `_bwd_common`, whose ds is
    p * (dp - dsum)). p is zeroed where masked: with a real lse that is
    exp(-1e30 - lse) = 0 anyway, and with the stats VJP's lse := m = -1e30
    (a row with no visible key) it is what the kernels give by skipping
    every tile with no visible key. One head at a time bounds the memory
    to a few (Sq, Sk) buffers."""
    qs, kf, vf, dof = (_scaled(q, scale).float(), k.float(), v.float(),
                       do.float())
    mask = None
    if causal:
        mask = _causal_mask(q.shape[0], k.shape[0], q_offset, k_offset,
                            q.device)
    for hh in range(q.shape[1]):
        s = qs[:, hh] @ kf[:, hh].T
        if mask is not None:
            s.masked_fill_(mask, _MASK)
        p = s.sub_(lse[hh][:, None]).exp_()
        if mask is not None:
            p.masked_fill_(mask, 0.0)
        yield hh, p, dof[:, hh] @ vf[:, hh].T


def _flash_backward_plain(q, k, v, do, lse, dsum, causal: bool,
                          scale: float, q_offset: int = 0,
                          k_offset: int = 0):
    """Plain version of the backward kernels: dense f32 per head, the
    reference's rounding points (`_flash_bwd_dq_kernel`,
    `_flash_bwd_dkv_kernel`): ds is rounded to k's dtype before dq =
    scale * ds.k and to q's before dk = scale * ds^T.q (q unscaled), p to
    dO's dtype before dv = p^T.dO; all sums f32. Causal masking compares
    global positions q_offset + i >= k_offset + j.

    q, do (Sq, H, D), k/v (Sk, H, D), lse and dsum (H, Sq) f32 ->
    dq, dk, dv in q's, k's and v's dtypes. dO may be f32 with bf16 q, k, v
    (the stats VJP's d_acc)."""
    qf, kf, dof = q.float(), k.float(), do.float()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for hh, p, dp in _bwd_tiles(q, k, v, do, lse, causal, scale, q_offset,
                                k_offset):
        dv[:, hh] = p.to(do.dtype).float().T @ dof[:, hh]
        dsr = dp.sub_(dsum[hh][:, None]).mul_(p).to(k.dtype).float()
        dq[:, hh] = (dsr @ kf[:, hh]) * scale
        dk[:, hh] = (dsr.T @ qf[:, hh]) * scale
    return dq, dk, dv


def _bwd_term_scales(q, k, v, do, lse, dsum, causal: bool, scale: float,
                     q_offset: int = 0, k_offset: int = 0):
    """(r_q, r_k, r_v) f32 in the shapes of dq, dk, dv: for each output
    element, sqrt of the sum of its terms' squares, e.g. r_v[j, h, c] =
    sqrt(sum_i p_ij^2 dO_ic^2) and r_q[i, h, c] = scale *
    sqrt(sum_j m_ij^2 k_jc^2). Summing n terms of random signs in another
    order moves the sum by ~eps * sqrt(n/2) * r, and rounding each term's p
    or ds at a neighbouring bf16 value moves it by a small multiple of
    2^-8 * r: what a check of the backward must allow for.

    m = |ds| + 2^-6 p (|dO|.|v| + |dsum|), not |ds| alone: where dp and
    dsum cancel (row 0 of a causal head sees one key, so its ds is 0 but
    for rounding) ds is the difference of two f32 sums taken in other
    orders on the two sides, off by a few eps times the sum of their terms'
    magnitudes rather than by eps |ds|. Elsewhere the added term is a few
    percent of |ds|."""
    qf, kf, dof = q.float(), k.float(), do.float()
    rq, rk, rv = (torch.empty(t.shape, dtype=torch.float32, device=t.device)
                  for t in (q, k, v))
    for hh, p, dp in _bwd_tiles(q, k, v, do, lse, causal, scale, q_offset,
                                k_offset):
        dsm = dsum[hh][:, None]
        mag = (dof[:, hh].abs() @ v[:, hh].float().abs().T).add_(dsm.abs())
        m = (dp.sub_(dsm).abs_().add_(mag, alpha=2.0 ** -6).mul_(p)
             .square_())
        del mag
        rv[:, hh] = (p.square_().T @ dof[:, hh].square()).sqrt_()
        rq[:, hh] = (m @ kf[:, hh].square()).sqrt_() * scale
        rk[:, hh] = (m.T @ qf[:, hh].square()).sqrt_() * scale
    return rq, rk, rv


# |kernel - plain| per element of a backward output, against the output's
# magnitude `want` and its term scale r (`_bwd_term_scales`):
# - f32: 2^-21 |want| + 2^-14 r. A few ulps of the result, plus ~10
#   standard deviations of summing n <= 16384 f32 terms in another order
#   (eps sqrt(n/2) r <= 2^-17.5 r, eps = 2^-24); r's cancellation part
#   covers each ds's own error. A tile of 64 terms missing moves an output
#   by ~8 r / sqrt(n): 0.06 r at n = 16384, ~1000 times the limit.
# - bf16: 2^-7 |want| + 2^-8 r. One output ulp (the two sides may round
#   their f32 sums to neighbouring bf16 values), plus the terms whose p or
#   ds rounds to the neighbouring bf16 value on one side only (each moves
#   its term by at most 2^-8 relative; few do, since the two sides' f32
#   values differ by ~1e-7 relative against a bf16 ulp of 2^-8).
_BWD_TOL = {torch.float32: (2.0 ** -21, 2.0 ** -14),
            torch.bfloat16: (2.0 ** -7, 2.0 ** -8)}


def _bwd_limits(q, k, v, do, lse, dsum, causal: bool, scale: float, want,
                q_offset: int = 0, k_offset: int = 0):
    """The per-element limits of (dq, dk, dv) against `want`, the plain
    version's (dq, dk, dv), by `_BWD_TOL`."""
    rel, noise = _BWD_TOL[q.dtype]
    return tuple(rel * w.float().abs() + noise * r for w, r in zip(
        want, _bwd_term_scales(q, k, v, do, lse, dsum, causal, scale,
                               q_offset, k_offset)))


def _check_shapes(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash attention takes q (Sq, H, D) and k/v "
                         f"(Sk, H, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[1:] != k.shape[1:]:
        raise ValueError(f"q and k/v differ in heads or head dim: "
                         f"{tuple(q.shape)} vs {tuple(k.shape)}")
    if k.shape[0] < 1:
        raise ValueError("flash attention needs at least one key")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must share a dtype; got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v must share a device; got {q.device}, "
                         f"{k.device}, {v.device}")


def _check_kernel_operands(q, k, v, **more):
    """What every flash kernel needs of its operands: one CUDA device, f32
    or bf16, D in HEAD_DIMS, unit stride along D and 16-byte aligned rows
    (`more`: further (S, H, D) operands, by name, checked alike)."""
    _check_shapes(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA flash kernel got a {q.device} tensor")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the flash kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {HEAD_DIMS}, "
                         f"got {q.shape[2]}")
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device; got "
                             f"{t.dtype} on {t.device}")
        _check_row_layout(name, t)


def _check_row_layout(name, t):
    """Unit stride along D and 16-byte aligned rows, as the kernels'
    16-byte loads and stores need."""
    vec = 16 // t.element_size()
    aligned = t.data_ptr() % 16 == 0 and all(
        t.stride(i) % vec == 0 for i in (0, 1) if t.shape[i] > 1)
    if t.stride(2) != 1 or not aligned:
        raise ValueError(f"{name} needs unit stride along D and 16-byte "
                         f"aligned rows; got strides {t.stride()}")


def flash_fwd(q, k, v, causal: bool, scale: float):
    """The CUDA kernel: out (Sq, H, D) in q's dtype and lse (H, Sq) f32.
    q/k/v are read through their strides; each needs unit stride along D
    and 16-byte aligned rows. Raises on what the kernel does not take."""
    _check_kernel_operands(q, k, v)
    sq, h, d = q.shape
    sk = k.shape[0]
    out = torch.empty((sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((h, sq), dtype=torch.float32, device=q.device)
    if sq == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), sq, sk, h, d, _DTYPE_CODE[q.dtype],
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), out.stride(0), out.stride(1),
            scale, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err}")
    launches["flash_fwd"] += 1
    return out, lse


def flash_forward_lse(q, k, v, causal: bool, scale: float):
    """(out, lse) by the tensor's device: the plain version on the CPU,
    the kernel on CUDA. No autograd (`flash_attention` has it)."""
    if q.device.type == "cuda":
        return flash_fwd(q, k, v, causal, scale)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")
    _check_shapes(q, k, v)
    return _flash_forward_lse_plain(q, k, v, causal, scale)


def flash_stats_fwd(q, k, v, q_offset: int, k_offset: int, causal: bool,
                    scale: float):
    """The CUDA kernel's stats form: acc (Sq, H, D) f32, m and l (H, Sq)
    f32 for one (q shard, kv shard) pair at global offsets. Operands as
    `flash_fwd` takes them. Raises on what the kernel does not take."""
    _check_kernel_operands(q, k, v)
    sq, h, d = q.shape
    acc = torch.empty((sq, h, d), dtype=torch.float32, device=q.device)
    m, l = (torch.empty((h, sq), dtype=torch.float32, device=q.device)
            for _ in range(2))
    if sq == 0:
        return acc, m, l
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().flash_stats_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), sq, k.shape[0], h, d,
            _DTYPE_CODE[q.dtype], q.stride(0), q.stride(1), k.stride(0),
            k.stride(1), v.stride(0), v.stride(1), acc.stride(0),
            acc.stride(1), scale, int(causal), int(q_offset), int(k_offset),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_stats_fwd launch failed: cudaError_t "
                           f"{err}")
    launches["flash_stats_fwd"] += 1
    return acc, m, l


def flash_stats_forward(q, k, v, q_offset: int, k_offset: int,
                        causal: bool, scale: float):
    """(acc, m, l) by the tensor's device: the plain version on the CPU,
    the kernel's stats form on CUDA. No autograd
    (`flash_attention_stats` has it)."""
    if q.device.type == "cuda":
        return flash_stats_fwd(q, k, v, q_offset, k_offset, causal, scale)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")
    _check_shapes(q, k, v)
    return _flash_stats_plain(q, k, v, q_offset, k_offset, causal, scale)


def _check_bwd_rows(q, lse, dsum):
    for name, t in (("lse", lse), ("dsum", dsum)):
        if t.shape != (q.shape[1], q.shape[0]) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be (H, Sq) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _bwd_operands(q, k, v, do, lse, dsum):
    """Checks the backward kernels' operands; returns their dtype code:
    q's, or 2 for bf16 q, k, v with an f32 dO (the stats VJP's d_acc)."""
    _check_kernel_operands(q, k, v)
    if do.shape != q.shape:
        raise ValueError(f"dO must have q's shape {tuple(q.shape)}, got "
                         f"{tuple(do.shape)}")
    code = _DTYPE_CODE[q.dtype]
    if do.dtype != q.dtype:
        if (q.dtype, do.dtype) != (torch.bfloat16, torch.float32):
            raise ValueError(f"dO must be q's dtype, or float32 with "
                             f"bfloat16 q; got {do.dtype} with {q.dtype}")
        code = 2
    if do.device != q.device:
        raise ValueError(f"dO must be on q's device; got {do.device}")
    _check_row_layout("dO", do)
    _check_bwd_rows(q, lse, dsum)
    if not (lse.device == dsum.device == q.device) or not (
            lse.is_contiguous() and dsum.is_contiguous()):
        raise ValueError("lse and dsum must be contiguous on q's device")
    return code


def _strides(*ts):
    return (_I64 * 12)(*(st for t in ts for st in t.stride()[:2]))


def flash_bwd_dq(q, k, v, do, lse, dsum, causal: bool, scale: float,
                 q_offset: int = 0, k_offset: int = 0):
    """The CUDA dq kernel: dq (Sq, H, D) in q's dtype from q, k, v, dO
    (read through their strides: unit stride along D, 16-byte aligned
    rows; dO in q's dtype, or f32 with bf16 q), lse and dsum (H, Sq) f32,
    at the blocks' global offsets. Raises on what it does not take."""
    code = _bwd_operands(q, k, v, do, lse, dsum)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.shape[0] == 0:
        return dq
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_library().flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(), q.shape[0],
            k.shape[0], q.shape[1], q.shape[2], code,
            _strides(q, k, v, do, dq, dq), scale, int(causal), int(q_offset),
            int(k_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq launch failed: cudaError_t {err}")
    launches["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, dsum, causal: bool, scale: float,
                  q_offset: int = 0, k_offset: int = 0):
    """The CUDA dk/dv kernel: dk, dv (Sk, H, D) in k's and v's dtype, from
    the operands of `flash_bwd_dq`."""
    code = _bwd_operands(q, k, v, do, lse, dsum)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_library().flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dsum.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            q.shape[0], k.shape[0], q.shape[1], q.shape[2], code,
            _strides(q, k, v, do, dk, dv), scale, int(causal), int(q_offset),
            int(k_offset), stream)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv launch failed: cudaError_t {err}")
    launches["flash_bwd_dkv"] += 1
    return dk, dv


def flash_backward(q, k, v, do, lse, dsum, causal: bool, scale: float,
                   need=(True, True, True), q_offset: int = 0,
                   k_offset: int = 0):
    """(dq, dk, dv) by the tensor's device: the plain version on the CPU,
    the two kernels on CUDA. `need` says which of the three are wanted
    (None for the others); on CUDA the dq kernel runs only for dq, the
    dk/dv kernel for either of the others."""
    offsets = (q_offset, k_offset)
    if q.device.type == "cuda":
        dq = dk = dv = None
        if need[0]:
            dq = flash_bwd_dq(q, k, v, do, lse, dsum, causal, scale,
                              *offsets)
        if need[1] or need[2]:
            dk, dv = flash_bwd_dkv(q, k, v, do, lse, dsum, causal, scale,
                                   *offsets)
    elif q.device.type == "cpu":
        _check_shapes(q, k, v)
        _check_bwd_rows(q, lse, dsum)
        dq, dk, dv = _flash_backward_plain(q, k, v, do, lse, dsum, causal,
                                           scale, *offsets)
    else:
        raise ValueError(f"no flash-attention path for device {q.device}")
    return tuple(g if n else None for g, n in zip((dq, dk, dv), need))


class _FlashAttention(torch.autograd.Function):
    """The flash forward and backward as one autograd node. The forward
    keeps q, k, v, out and lse (the reference's residuals, `:680`); the
    backward computes dsum = rowsum(dO * O) in f32 outside the kernels, as
    the reference does (`:604-609`), and returns the gradients in q's,
    k's and v's dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_forward_lse(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        do = grad_out.to(out.dtype).contiguous()
        dsum = (do.float() * out.float()).sum(-1).T.contiguous()
        return (*flash_backward(q, k, v, do, lse, dsum, ctx.causal,
                                ctx.scale, need=ctx.needs_input_grad[:3]),
                None, None)


def _reject_tpu_knobs(**knobs):
    for name, val in knobs.items():
        if val is not None:
            raise ValueError(
                f"{name} is a TPU tiling/interpret knob of the JAX package; "
                f"the port's kernel uses its own 64 x 64 tile and has no "
                f"interpret mode")


class _FlashStats(torch.autograd.Function):
    """The stats forward and its flash backward as one autograd node (the
    reference's `_flash_stats_vjp`, `:255-350`). The forward keeps q, k, v
    and m; the backward runs the backward kernels (the plain version on
    the CPU) with lse := m, dsum := -d_l and dO := d_acc (f32) at the
    pair's offsets, and drops d_m: for a shift-invariant consumer, one
    with G(acc e^-c, m + c, l e^-c) = G(acc, m, l) such as the ring merge,
    the m cotangent cancels the argmax terms exactly (the derivation at
    `:304-315`)."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, k_offset, causal, scale):
        acc, m, l = flash_stats_forward(q, k, v, q_offset, k_offset, causal,
                                        scale)
        ctx.save_for_backward(q, k, v, m)
        ctx.offsets = (q_offset, k_offset)
        ctx.causal, ctx.scale = causal, scale
        return acc, m, l

    @staticmethod
    def backward(ctx, d_acc, d_m, d_l):
        q, k, v, m = ctx.saved_tensors
        # f32 whatever q's dtype, as the reference's da_h (:336): for bf16
        # inputs the dv product then rounds p to f32, i.e. not at all
        do = d_acc.float().contiguous()
        dsum = (-d_l.float()).contiguous()
        return (*flash_backward(q, k, v, do, m, dsum, ctx.causal, ctx.scale,
                                need=ctx.needs_input_grad[:3],
                                q_offset=ctx.offsets[0],
                                k_offset=ctx.offsets[1]),
                None, None, None, None)


def flash_attention_stats(q, k, v, q_offset, k_offset, causal: bool,
                          scale: float, block_q=None, block_k=None,
                          interpret=None):
    """Streaming-softmax partial attention for one K/V block: returns the
    unnormalized accumulator acc (Sq, H, D) f32 and the (m, l) carry
    (H, Sq) f32, in the shapes ring attention merges. q_offset/k_offset
    are the blocks' global positions (causal masking across shards).
    Differentiable with the flash backward, exact for shift-invariant
    consumers such as the ring merge (`_FlashStats`).

    A q row with no visible key in this block comes out flagged by
    m == -1e30 (with acc = 0 and l = 0 where the kernel skips its tiles,
    finite garbage where a computed tile masks all its keys): consumers
    weigh such rows with exp(m - m_new) = 0, as the ring merge does,
    instead of normalizing acc/l directly. `block_q`, `block_k` and
    `interpret` are rejected, as in `flash_attention`."""
    _reject_tpu_knobs(block_q=block_q, block_k=block_k, interpret=interpret)
    return _FlashStats.apply(q, k, v, int(q_offset), int(k_offset),
                             bool(causal), float(scale))


def flash_attention(q, k, v, causal: bool = False, scale=None,
                    block_q=None, block_k=None, interpret=None):
    """Exact attention without the (S, S) HBM score matrix.

    q: (Sq, H, D); k/v: (Sk, H, D). Returns (Sq, H, D) in q's dtype.
    `scale` defaults to 1/sqrt(D). `block_q`, `block_k` and `interpret`
    are the reference's TPU tiling and interpret knobs and are rejected."""
    _reject_tpu_knobs(block_q=block_q, block_k=block_k, interpret=interpret)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))
