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

Over a mesh that spans processes each process drives its own positions:
a k/v block whose next position lives on another process goes there as a
tagged message (`cluster.Link`; `RingLink` says who owns which position),
its cotangent comes back in the backward, and the pairs and the merge are
the one-process ring's, so two processes compute what one does. The
public functions then take the same full q/k/v on every process and
return the full output on every process, as the reference's global
arrays behave.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..ops.flash_attention import (_MASK, _scaled, flash_attention,
                                   flash_attention_stats)
from . import cluster
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


class RingLink(NamedTuple):
    """The ring's positions over processes: `owners[j]` is the process of
    position j, `tag(j, step)` the message tag of the k/v block that
    reaches position j after ring step `step`, `link` the program's
    `cluster.Link`."""
    link: object
    owners: tuple
    tag: Callable


def _ring_attention_sharded(qs, ks, vs, causal: bool, scale: float,
                            block_impl: str = "dense", ring=None):
    """The reference's per-device ring program, run for every position:
    qs/ks/vs are the positions' (block, H, D) shards, each on its
    position's device. Returns the positions' output shards.

    At step i position j holds the k/v block of src = (j + i) % n and
    attends to it with offsets (j * block, src * block); the blocks then
    move one position down the ring (the reference's ppermute j -> j - 1).
    The merge is the reference's, with f32 carries.

    With `ring` (a `RingLink`) the positions span processes: the shards
    of other processes' positions are None (and so are their outputs),
    and a block whose next position is another process's goes there as
    one message a ring step, k and v stacked."""
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
    mine = [j for j in range(n) if qs[j] is not None]
    if not flash:
        qs = [None if q is None else _scaled(q, scale) for q in qs]
    block, h, _ = qs[mine[0]].shape
    devs = [None if q is None else q.device for q in qs]
    acc = {j: torch.zeros(qs[j].shape, dtype=torch.float32, device=devs[j])
           for j in mine}
    m_run = {j: torch.full((h, block), _MASK, device=devs[j]) for j in mine}
    l_run = {j: torch.zeros((h, block), device=devs[j]) for j in mine}
    kv = [None if k is None else (k, v) for k, v in zip(ks, vs)]
    for i in range(n):
        for j in mine:
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
            kv = _rotate(kv, devs, ring, i)
    out = [None] * n
    for j in mine:
        out[j] = (acc[j] / l_run[j].clamp_min(1e-30).T[:, :, None]).to(
            qs[j].dtype)
    return out


def _rotate(kv, devs, ring, step):
    """Every position's next k/v block: position j takes j + 1's, by
    `.to` where both are this process's and as a message (`ring`) where
    one of them is another process's."""
    n = len(kv)
    new = [None] * n
    sends, recvs = [], []
    for j in range(n):
        nxt = (j + 1) % n
        if kv[nxt] is not None and devs[j] is not None:
            new[j] = tuple(t.to(devs[j]) for t in kv[nxt])
        elif kv[nxt] is not None:
            sends.append((torch.stack(kv[nxt]), ring.owners[j],
                          ring.tag(j, step)))
        elif devs[j] is not None:
            k = kv[j][0]
            recvs.append((j, ((2,) + tuple(k.shape), k.dtype, devs[j],
                              ring.owners[nxt], ring.tag(j, step))))
    if sends or recvs:
        got = ring.link.messages(sends, [r for _, r in recvs])
        for (j, _), t in zip(recvs, got):
            new[j] = tuple(t.unbind(0))
    return new


def _shards(x, devs):
    """x (S, ...) cut into len(devs) equal blocks along S, block j on
    devs[j] (None where devs[j] is another process's)."""
    block = x.shape[0] // len(devs)
    return [None if d is None else x[j * block:(j + 1) * block].to(d)
            for j, d in enumerate(devs)]


def _axis_line(mesh, axis, seq, what):
    """The positions along `axis` with every other axis at 0: (their
    devices, None where another process's; their processes). The
    sequence length `seq` must split over them."""
    n = mesh.shape[axis]
    if seq % n:
        raise ValueError(f"{what} shards the sequence over the {n} "
                         f"positions of mesh axis {axis!r}; length {seq} "
                         f"is not divisible")
    coords = [{axis: j} for j in range(n)]
    devs = [mesh.device_at(**c) if mesh.is_local(**c) else None
            for c in coords]
    return devs, tuple(mesh.process_of(**c) for c in coords)


def _spanning_call(mesh, q, k, v, n):
    """A `cluster.Link` for one call over processes (sends of the
    previous call waited for first) and its messages' tags, step x
    position."""
    mesh.exchange.wait_sends()
    tags = cluster.MessageTags(step=n, position=n)
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    return cluster.Link(mesh.exchange, tags, q.device,
                        differentiable=grad), tags


def ring_attention(q, k, v, mesh=None, axis: str = DATA_AXIS,
                   causal: bool = False, scale=None,
                   block_impl: str = "dense"):
    """Exact attention over a sequence sharded across `mesh`'s `axis`
    (default: `data_mesh()`, the visible cards).

    q/k/v: (seq, heads, dim) with seq divisible by the axis size; block j
    runs on the axis' j-th device. Returns (seq, heads, dim) in q's dtype
    on q's device. block_impl="flash" computes each pair with the flash
    kernel's stats form; "dense" with dense f32 scores.

    Over a mesh that spans processes (a collective: every process calls
    it with the same q/k/v) each process runs the axis' positions it
    owns (the others' at 0) and returns the whole output; in the
    backward each process's q/k/v gradients hold the rows of its own
    positions and zeros elsewhere (the shards a process holds of the
    reference's global gradient), so their sum over the processes is the
    one-process gradient."""
    if block_impl not in ("dense", "flash"):
        raise ValueError(f"block_impl must be dense|flash, got "
                         f"{block_impl!r}")
    mesh = mesh or data_mesh()
    devs, owners = _axis_line(mesh, axis, q.shape[0], "ring_attention")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n = len(devs)
    ring = None
    if None in devs:        # some positions are other processes'
        link, tags = _spanning_call(mesh, q, k, v, n)
        ring = RingLink(link, owners, lambda j, step: tags(step=step,
                                                           position=j))
    outs = _ring_attention_sharded(_shards(q, devs), _shards(k, devs),
                                   _shards(v, devs), causal, float(scale),
                                   block_impl, ring=ring)
    if ring is None:
        return torch.cat([o.to(q.device) for o in outs])
    block = q.shape[0] // n
    return link.gather(outs, owners, 0, q.device,
                       lambda j: tags(step=n - 1, position=j),
                       ((block,) + tuple(q.shape[1:]), q.dtype))


def _ulysses_group(q, k, v, causal: bool, scale: float):
    """One head group's dense attention over the whole sequence."""
    seq = q.shape[0]
    mask = (_causal_additive(0, 0, seq, seq, q.device) if causal
            else None)
    o, _, l = _block_attend(_scaled(q, scale), k, v, mask)
    return (o / l.clamp_min(1e-30).T[:, :, None]).to(q.dtype)


def ulysses_attention(q, k, v, mesh=None, axis: str = DATA_AXIS,
                      causal: bool = False, scale=None):
    """All-to-all sequence parallelism (the Ulysses layout); needs
    heads % axis size == 0. The contract of `ring_attention`. The caller
    holds the whole q/k/v, so the first all-to-all (head group g of
    every sequence shard to position g) is a slice: position g attends
    for its heads over the whole sequence, and the second all-to-all is
    the concatenation of the groups, gathered from other processes where
    the axis spans them (gradients: each process's head groups)."""
    mesh = mesh or data_mesh()
    n = mesh.shape[axis]
    if q.shape[1] % n:
        raise ValueError(
            f"ulysses_attention needs heads ({q.shape[1]}) divisible by the "
            f"mesh axis size ({n}); use ring_attention otherwise")
    devs, owners = _axis_line(mesh, axis, q.shape[0], "ulysses_attention")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    hg = q.shape[1] // n
    groups = [None] * n
    for g, dev in enumerate(devs):
        if dev is not None:
            heads = slice(g * hg, (g + 1) * hg)
            groups[g] = _ulysses_group(q[:, heads].to(dev),
                                       k[:, heads].to(dev),
                                       v[:, heads].to(dev), causal,
                                       float(scale))
    if None not in devs:
        return torch.cat([o.to(q.device) for o in groups], dim=1)
    link, tags = _spanning_call(mesh, q, k, v, n)
    return link.gather(groups, owners, 1, q.device,
                       lambda g: tags(step=0, position=g),
                       ((q.shape[0], hg, q.shape[2]), q.dtype))
