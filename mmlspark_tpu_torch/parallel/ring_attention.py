"""Dense single-device attention (port of the dense path of
`mmlspark_tpu/parallel/ring_attention.py`).

`reference_attention` is the encoder's dense path and the tests' oracle.
The sequence-parallel strategies, `ring_attention` (K/V rotating around a
ring of devices) and `ulysses_attention` (all-to-all re-sharding), need
`torch.distributed` and are not ported yet: they raise.
"""
from __future__ import annotations

import math

import torch

_SEQ_PARALLEL_TODO = ("sequence-parallel attention (ring/ulysses) needs "
                      "torch.distributed and is not ported yet: ROADMAP "
                      "Queue 1 item 15")


def reference_attention(q, k, v, causal: bool = False, scale=None,
                        key_mask=None):
    """Softmax attention with the reference's rounding points.

    q (S, H, D), k/v (Sk, H, D), or each with one leading batch dimension
    (B, S, H, D) (the batched `transform()`; the reference vmaps instead).
    key_mask: optional (Sk,) or (B, Sk) bool; False keys (padding) are
    excluded from every query's softmax.

    q * scale is taken in q's dtype, scores are f32, causal and key_mask
    mask with -inf, fully masked rows (an empty document) come out 0, p is
    cast to v's dtype before the PV product and the result to q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    s = torch.einsum("...qhd,...khd->...hqk", qs.float(), k.float())
    if causal:
        n = q.shape[-3]
        pos = torch.arange(n, device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
    if key_mask is not None:
        km = key_mask.to(device=s.device, dtype=torch.bool)
        s = s.masked_fill(~km[..., None, None, :], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1))
    out = torch.einsum("...hqk,...khd->...qhd", p.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh=None, causal: bool = False, scale=None):
    raise NotImplementedError(_SEQ_PARALLEL_TODO)


def ulysses_attention(q, k, v, mesh=None, causal: bool = False, scale=None):
    raise NotImplementedError(_SEQ_PARALLEL_TODO)
