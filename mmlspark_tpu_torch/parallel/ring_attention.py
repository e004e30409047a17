"""Sequence-parallel attention: ring attention and Ulysses all-to-all
(port of `mmlspark_tpu/parallel/ring_attention.py`).

- `ring_attention`: each position of a mesh axis holds one sequence block
  of q/k/v; k/v blocks rotate around the ring while a streaming softmax
  (running max m, denominator l, unnormalized accumulator) merges each
  (q block, kv block) pair into exact attention. Causal masking uses the
  blocks' global offsets. `block_impl="flash"` computes each pair with the
  flash kernel's stats form (`ops/flash_attention.flash_attention_stats`,
  and its flash backward), "dense" with `_block_attend`.
- `ulysses_attention`: re-shards sequence -> heads, runs dense attention
  for each head group over the full sequence, and re-shards back.

The reference runs both inside `shard_map` with `ppermute`/`all_to_all`;
here one process drives every position (`parallel/mesh.py`): a shard is
placed on its position's device and moving it to the next position is
`.to(device)`, which costs nothing where two positions share a device.
Both are exact, and `reference_attention` is the single-device oracle
and the encoder's dense path.
"""
from __future__ import annotations

import math

import torch

from ..ops.flash_attention import (_MASK, _scaled, flash_attention,
                                   flash_attention_stats)
from .mesh import DATA_AXIS, data_mesh


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
    s = torch.einsum("...qhd,...khd->...hqk", _scaled(q, scale).float(),
                     k.float())
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


def _block_attend(q, k, v, mask=None):
    """Scores of one (q block, kv block) pair and their streaming-softmax
    stats: q (B, H, D) already scaled, k/v (Bk, H, D), mask None or (B, Bk)
    additive (0 or -inf). Scores and stats are f32; the block output is
    p (rounded to v's dtype) . v rounded to v's dtype, as the reference's
    einsum returns it, then f32. Returns o (B, H, D) f32, m and l (H, B)."""
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float())
    if mask is not None:
        s = s + mask[None]
    # finite floor: a fully masked row has max -inf, and exp(-inf - -inf)
    # would be NaN; clamped, its p is exactly 0
    m = s.amax(-1).clamp_min(_MASK)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("hqk,khd->qhd", p.to(v.dtype).float(), v.float())
    return o.to(v.dtype).float(), m, l


def _causal_additive(q_off: int, k_off: int, bq: int, bk: int, device):
    q_pos = q_off + torch.arange(bq, device=device)
    k_pos = k_off + torch.arange(bk, device=device)
    return torch.zeros((bq, bk), device=device).masked_fill_(
        q_pos[:, None] < k_pos[None, :], float("-inf"))


def _ring_attention_sharded(qs, ks, vs, causal: bool, scale: float,
                            block_impl: str = "dense"):
    """The reference's per-device ring program, run for every position:
    qs/ks/vs are the positions' (block, H, D) shards, each on its
    position's device. Returns the positions' output shards.

    At step i position j holds the k/v block of src = (j + i) % n and
    attends to it with offsets (j * block, src * block); the blocks then
    move one position down the ring (the reference's ppermute j -> j - 1).
    The merge is the reference's, with f32 carries."""
    n = len(qs)
    if n == 1:
        # a singleton axis degenerates to ordinary attention: the fused
        # normalized path, one block at offset 0
        if block_impl == "flash":
            return [flash_attention(qs[0], ks[0], vs[0], causal=causal,
                                    scale=scale)]
        return [reference_attention(qs[0], ks[0], vs[0], causal=causal,
                                    scale=scale)]
    flash = block_impl == "flash"
    if not flash:
        qs = [_scaled(q, scale) for q in qs]   # flash scales in its kernel
    block, h, _ = qs[0].shape
    devs = [q.device for q in qs]
    acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    m_run = [torch.full((h, block), _MASK, device=d) for d in devs]
    l_run = [torch.zeros((h, block), device=d) for d in devs]
    kv = list(zip(ks, vs))
    for i in range(n):
        for j in range(n):
            src = (j + i) % n
            k_blk, v_blk = kv[j]
            if flash:
                o, m_blk, l_blk = flash_attention_stats(
                    qs[j], k_blk, v_blk, j * block, src * block, causal,
                    scale)
            else:
                mask = (_causal_additive(j * block, src * block, block,
                                         block, devs[j]) if causal else None)
                o, m_blk, l_blk = _block_attend(qs[j], k_blk, v_blk, mask)
            m_new = torch.maximum(m_run[j], m_blk)
            alpha = torch.exp(m_run[j] - m_new)        # rescale the old
            beta = torch.exp(m_blk - m_new)            # rescale the new
            l_run[j] = l_run[j] * alpha + l_blk * beta
            acc[j] = acc[j] * alpha.T[:, :, None] + o * beta.T[:, :, None]
            m_run[j] = m_new
        if i < n - 1:
            kv = [tuple(t.to(devs[j]) for t in kv[(j + 1) % n])
                  for j in range(n)]
    return [(a / lr.clamp_min(1e-30).T[:, :, None]).to(q.dtype)
            for a, lr, q in zip(acc, l_run, qs)]


def _shards(x, devs):
    """x (S, ...) cut into len(devs) equal blocks along S, block j on
    devs[j]."""
    block = x.shape[0] // len(devs)
    return [x[j * block:(j + 1) * block].to(d) for j, d in enumerate(devs)]


def _axis_devices(mesh, axis, seq, what):
    mesh = mesh or data_mesh()
    mesh.single_process(what)
    devs = mesh.axis_devices(axis)
    if seq % len(devs):
        raise ValueError(f"{what} shards the sequence over the {len(devs)} "
                         f"positions of mesh axis {axis!r}; length {seq} is "
                         f"not divisible")
    return devs


def ring_attention(q, k, v, mesh=None, axis: str = DATA_AXIS,
                   causal: bool = False, scale=None,
                   block_impl: str = "dense"):
    """Exact attention over a sequence sharded across `mesh`'s `axis`
    (default: `data_mesh()`, the visible cards).

    q/k/v: (seq, heads, dim) with seq divisible by the axis size; block j
    runs on the axis' j-th device. Returns (seq, heads, dim) in q's dtype
    on q's device. block_impl="flash" computes each pair with the flash
    kernel's stats form; "dense" with dense f32 scores."""
    if block_impl not in ("dense", "flash"):
        raise ValueError(f"block_impl must be dense|flash, got "
                         f"{block_impl!r}")
    devs = _axis_devices(mesh, axis, q.shape[0], "ring_attention")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    outs = _ring_attention_sharded(_shards(q, devs), _shards(k, devs),
                                   _shards(v, devs), causal, float(scale),
                                   block_impl)
    return torch.cat([o.to(q.device) for o in outs])


def _ulysses_sharded(qs, ks, vs, causal: bool, scale: float):
    """The reference's per-device Ulysses program, run for every position:
    sequence shards in, sequence shards out. Head group g of the full
    sequence goes to position g (the first all_to_all), each position runs
    dense attention for its heads, and block j of every group comes back
    to position j, its heads in group order (the second)."""
    n = len(qs)
    block, h, _ = qs[0].shape
    hg = h // n
    devs = [q.device for q in qs]

    def to_heads(xs):
        return [torch.cat([x[:, g * hg:(g + 1) * hg].to(devs[g])
                           for x in xs]) for g in range(n)]
    qh, kh, vh = to_heads(qs), to_heads(ks), to_heads(vs)
    seq = block * n
    outs = []
    for g in range(n):
        mask = (_causal_additive(0, 0, seq, seq, devs[g]) if causal
                else None)
        o, _, l = _block_attend(_scaled(qh[g], scale), kh[g], vh[g], mask)
        outs.append((o / l.clamp_min(1e-30).T[:, :, None]).to(qs[0].dtype))
    return [torch.cat([o[j * block:(j + 1) * block].to(devs[j])
                       for o in outs], dim=1) for j in range(n)]


def ulysses_attention(q, k, v, mesh=None, axis: str = DATA_AXIS,
                      causal: bool = False, scale=None):
    """All-to-all sequence parallelism (the Ulysses layout); needs
    heads % axis size == 0. The contract of `ring_attention`."""
    mesh = mesh or data_mesh()
    n = mesh.shape[axis]
    if q.shape[1] % n:
        raise ValueError(
            f"ulysses_attention needs heads ({q.shape[1]}) divisible by the "
            f"mesh axis size ({n}); use ring_attention otherwise")
    devs = _axis_devices(mesh, axis, q.shape[0], "ulysses_attention")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    outs = _ulysses_sharded(_shards(q, devs), _shards(k, devs),
                            _shards(v, devs), causal, float(scale))
    return torch.cat([o.to(q.device) for o in outs])
