"""Exact attention without the (S, S) score matrix: the flash forward.

Port of `mmlspark_tpu/ops/flash_attention.py` (forward only). The public
layout is the reference's: q (Sq, H, D), k/v (Sk, H, D), out (Sq, H, D) in
q's dtype; Sk may differ from Sq, and causal masking compares raw
positions (`q_pos >= k_pos`, top-left aligned when Sq != Sk).

The tensor's device chooses the path: a CPU tensor takes
`_flash_forward_lse_plain` (dense f32 scores, the reference's semantics);
a CUDA tensor launches the hand-written kernel in `csrc/flash_attention.cu`
(f32 or bf16, D in {16, 32, 64, 128}) or raises. Nothing falls back.

The reference's `block_q`/`block_k` (v5e VMEM tiling) and `interpret`
(Pallas interpret mode) have no meaning here: the kernel uses its own
64 x 64 tile, so `flash_attention` rejects them. The backward (the dq and
dk/dv kernels) and the ring-attention stats forward are not ported yet;
a gradient through `flash_attention` raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# launches of the kernel, counted where the wrapper launches it (and
# nowhere else) so a run can show that its path went through the kernel
launches = {"flash_fwd": 0}

HEAD_DIMS = (16, 32, 64, 128)     # the kernel's instantiations
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MASK = -1e30                     # the reference's mask value, not -inf
_BACKWARD_TODO = ("the flash-attention backward (the dq and dk/dv kernels) "
                  "is not ported yet: ROADMAP Queue 1 item 16(b), the "
                  "training slice")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_lib = None


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
        _lib = lib
    return _lib


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


def _bf16_rounding_scale(q, k, v, causal: bool, scale: float):
    """sqrt(sum_j p_j^2 v_j^2) / sum_j p_j for each output element (Sq, H, D)
    f32, with p_j the row's softmax weights.

    Rounding each p_j with a relative error e_j moves that output by
    sum_j p_j e_j v_j / sum_j p_j, whose standard deviation is this scale
    times the std of e: what a bf16 check must allow for where two
    versions round p at different points. Computed with the plain version
    on f32 copies: sum_j p_j^2 v_j^2 / (sum_j p_j)^2 is the attention of
    v^2 under doubled scores times exp(lse(2 s) - 2 lse(s))."""
    q, k, v = (t.float() for t in (q, k, v))
    _, lse = _flash_forward_lse_plain(q, k, v, causal, scale)
    out2, lse2 = _flash_forward_lse_plain(q, k, v * v, causal, 2 * scale)
    return (out2 * (lse2 - 2 * lse).exp().T[:, :, None]).sqrt()


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


def flash_fwd(q, k, v, causal: bool, scale: float):
    """The CUDA kernel: out (Sq, H, D) in q's dtype and lse (H, Sq) f32.
    q/k/v are read through their strides; each needs unit stride along D
    and 16-byte aligned rows. Raises on what the kernel does not take."""
    _check_shapes(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA flash kernel got a {q.device} tensor")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the flash kernel takes float32 or bfloat16, got "
                         f"{q.dtype}")
    sq, h, d = q.shape
    sk = k.shape[0]
    if d not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {HEAD_DIMS}, "
                         f"got {d}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        aligned = t.data_ptr() % 16 == 0 and all(
            t.stride(i) % vec == 0 for i in (0, 1) if t.shape[i] > 1)
        if t.stride(2) != 1 or not aligned:
            raise ValueError(f"{name} needs unit stride along D and 16-byte "
                             f"aligned rows; got strides {t.stride()}")
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
    the kernel on CUDA. No autograd (see `flash_attention`)."""
    if q.device.type == "cuda":
        return flash_fwd(q, k, v, causal, scale)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention path for device {q.device}")
    _check_shapes(q, k, v)
    return _flash_forward_lse_plain(q, k, v, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """The forward as an autograd node, so that an input that requires grad
    gets an error at backward time instead of silently no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        return flash_forward_lse(q, k, v, causal, scale)[0]

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(_BACKWARD_TODO)


def flash_attention(q, k, v, causal: bool = False, scale=None,
                    block_q=None, block_k=None, interpret=None):
    """Exact attention without the (S, S) HBM score matrix.

    q: (Sq, H, D); k/v: (Sk, H, D). Returns (Sq, H, D) in q's dtype.
    `scale` defaults to 1/sqrt(D). `block_q`, `block_k` and `interpret`
    are the reference's TPU tiling and interpret knobs and are rejected."""
    for name, val in (("block_q", block_q), ("block_k", block_k),
                      ("interpret", interpret)):
        if val is not None:
            raise ValueError(
                f"{name} is a TPU tiling/interpret knob of the JAX package; "
                f"the port's kernel uses its own 64 x 64 tile and has no "
                f"interpret mode")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(scale))
