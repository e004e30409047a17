"""Causal LM training over a data x pipe x model x seq mesh (port of
`mmlspark_tpu/models/dnn/pp_training.py`).

The reference's `PipelinedLMTrainer` runs a GPipe schedule in one
`shard_map` over a mesh that may compose data, pipe, tensor and sequence
parallelism. This module ports it in single-controller form
(`parallel/mesh.py`): one process drives every position, places each
block of the parameters on its position's device and moves activations
between positions with `.to(device)`, the identity where two positions
share a device. It keeps the reference's blocks (`_block_attn`,
`_block_ff`, `_block`), its loss (next-token targets across sequence
shards, the globally last position masked, a masked sum over the
microbatches divided by M * mb * (S_loc * cp - 1), the mean over data
shards), bf16 mixed precision with f32 master weights and optimizer
state, `remat` through `torch.utils.checkpoint`, and attention="flash"
through the flash kernels with their backward.

- pipe: the stacked (L, ...) layers are cut into P stages of L/P layers,
  each held on its stage's devices. At tick t of M + P - 1, stage s runs
  microbatch t - s and its output hops to stage s + 1; a (stage, tick)
  pair outside the schedule (a bubble) computes nothing.
- model: Megatron slices (`_MODEL_DIM`): wq/wk/wv/w1/b1 cut on their
  outputs, wo/w2 on their inputs, each model position computing its
  h / tp heads and d_ff / tp hidden units. `_tp_f` copies the layer-normed
  input to every model position (its backward sums their cotangents) and
  `_tp_g` sums the partial outputs on the stage's home position, model 0
  (its backward hands each its cotangent). The layer norms, residual adds,
  embedding and head run once per (data shard, stage, seq shard), on the
  home position, as the reference's replicated work counts once.
- seq: the sequence is cut into cp shards and attention is ring attention
  over them (`parallel/ring_attention._ring_attention_sharded`, the flash
  kernel's stats form for attention="flash"), inside each model position
  at its h / tp heads.
- data: batch rows shard over data; every data shard computes with its own
  differentiable copies of the masters, so autograd's sum over the copies
  is the reference's psum, and the loss's mean over data shards its pmean.

Every master lives once (`_Blocks`): a stage's model-j blocks on the
device at (data 0, pipe s, model j, seq 0), ln1/ln2/b2 once per stage at
model 0, embed/pos/final_ln on the mesh's first device. Stage 0's lookup
and the last stage's tied head use copies of the one embed, and autograd
sums them, as the reference's pipe psum does. `params` reads them in the
reference's layout.

Over a mesh that spans processes (`parallel.grid_mesh` in a job that
`parallel.cluster.initialize_cluster` formed) every process seeds
`init_transformer` alike and keeps the masters of its own positions only
(`_Span`): a block of layers on each process that owns one of its
positions, the shared embed/pos/final_ln on each process that owns a home
position of the first or the last stage (Megatron's tied embedding).
Inside a step the tensors that cross processes are tagged messages in
autograd (`cluster.Link`): the stage hop, Megatron's f and g where a model
position is another process's, and the ring's k/v blocks. After the
backward every replicated master's gradient is summed over its processes
in rank order (`cluster.Exchange.ordered_sum`), so each replica takes the
same step bit for bit, and so is the loss, so every process returns the
same float. `params` and `position_params` are then collectives: call
them on every process.

The flash kernels take one (S, H, D) sequence, so a microbatch's
sequences are looped over inside the attention sublayer (ROADMAP Queue 1
item 25: a batched kernel).
"""
from __future__ import annotations

import contextlib
import functools
import math
import operator
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from ...ops.flash_attention import flash_attention
from ...parallel import cluster
from ...parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS
from ...parallel.ring_attention import (RingLink, _ring_attention_sharded,
                                        reference_attention)
from .transformer import _layer_norm, _structure, _unflatten, \
    init_transformer

# the Megatron layout: the dimension of each layer leaf cut over the model
# axis, counted from the end so that it names the same dimension of a
# stacked (L, ...) leaf and of one layer's; ln1, ln2 and b2 are replicated
# in the reference and held once, at model position 0
_MODEL_DIM = {"wq": -1, "wk": -1, "wv": -1, "w1": -1, "b1": -1,
              "wo": -2, "w2": -2}


def _megatron_index(key: str, shape, j: int, tp: int, lead=()):
    """The index of model position j's block of layer leaf `key` of
    `shape`: its j-th of tp equal blocks along `_MODEL_DIM[key]`, or a
    replicated leaf whole at j = 0 and nowhere else (None). `lead`
    indexes the leading dimensions first (a stage's layers)."""
    if key not in _MODEL_DIM:
        return tuple(lead) if j == 0 else None
    dim = len(shape) + _MODEL_DIM[key]
    size = shape[dim] // tp
    return (tuple(lead) + (slice(None),) * (dim - len(lead))
            + (slice(j * size, (j + 1) * size),))


def _paths(tree, path=()):
    """(path, leaf) of a tree of dicts and lists, in
    `jax.tree_util.tree_flatten` order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


class _Blocks:
    """A parameter tree held in blocks over a mesh's positions, the
    reference's shardings in single-controller form.

    `placement(path, shape)` yields (position key, device, index) for
    each block of a leaf; a device of None is a block only other
    processes hold. `trees[key]` is the position's masters: dicts (a
    list's items under int keys) of f32 tensors on its device that
    autograd tracks. `pieces[i]` holds, for the i-th leaf of the full
    tree in flatten order, this process's (master, index into the full
    leaf); a leaf held whole has the one piece (master, ()).
    `layout[i]` lists every block of the leaf, (key, index, master or
    None). `span` is the trainer's `_Span` over processes, else None."""

    def __init__(self, full: dict, placement, span=None):
        self.structure = _structure(full)
        self.span = span
        self.shapes, self.pieces, self.layout, self.trees = [], [], [], {}
        for path, leaf in _paths(full):
            leaf = np.asarray(leaf, np.float32)
            self.shapes.append(leaf.shape)
            pieces, layout = [], []
            for key, dev, index in placement(path, leaf.shape):
                block = leaf[index]
                if block.shape == leaf.shape:
                    index = ()
                if dev is None:
                    layout.append((key, index, None))
                    continue
                m = torch.as_tensor(np.ascontiguousarray(block)).to(dev)
                m.requires_grad_(True)
                node = self.trees.setdefault(key, {})
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = m
                pieces.append((m, index))
                layout.append((key, index, m))
            self.pieces.append(pieces)
            self.layout.append(layout)

    def masters(self) -> list:
        return [m for pieces in self.pieces for m, _ in pieces]

    def leaves(self, device, get=None) -> list:
        """Every leaf of the full tree in flatten order (`_gather`). Over
        processes a collective: each block comes from the lowest process
        that holds it, and a leaf held whole here is its master."""
        if self.span is None:
            return [_gather(p, shape, device, get)
                    for p, shape in zip(self.pieces, self.shapes)]
        get = get or (lambda m: m)
        mine = {(i, k): get(m).detach().cpu().numpy()
                for i, layout in enumerate(self.layout)
                for k, (key, _, m) in enumerate(layout)
                if m is not None and self.span.canonical(key)}
        got = {}
        for part in cluster.all_gather_object(mine):
            got.update(part)
        out = []
        for i, (layout, shape) in enumerate(zip(self.layout, self.shapes)):
            if len(layout) == 1 and layout[0][1] == () and \
                    layout[0][2] is not None:
                out.append(get(layout[0][2]))
                continue
            with torch.no_grad():
                full = torch.empty(shape, dtype=torch.float32, device=device)
                for k, (_, index, _) in enumerate(layout):
                    full[index] = torch.as_tensor(got[i, k]).to(device)
            out.append(full)
        return out

    def tree(self, device) -> dict:
        """The parameters in the reference's layout: a leaf held whole is
        its master, a cut one a detached tensor on `device` assembled
        from its blocks (over processes: `leaves`, a collective)."""
        return _unflatten(self.structure, self.leaves(device))

    def key_tree(self, key, device) -> dict:
        """Position `key`'s masters; over processes a collective that
        returns another process's as detached tensors on `device`."""
        if self.span is None:
            return self.trees[key]
        own = self.span.canonical(key)
        mine = (_tree_map(lambda a: a.detach().cpu().numpy(),
                          self.trees[key]) if own else None)
        got = next(t for t in cluster.all_gather_object(mine)
                   if t is not None)
        if key in self.trees:
            return self.trees[key]
        return _tree_map(lambda a: torch.as_tensor(a).to(device), got)


def _gather(pieces, shape, device, get=None):
    """One leaf from its (master, index) pieces: `get(master)` (default:
    the master) where one piece holds it whole, else a tensor of `shape`
    on `device` assembled from `get` of each piece, detached."""
    get = get or (lambda m: m)
    if pieces[0][1] == ():
        return get(pieces[0][0])
    with torch.no_grad():
        out = torch.empty(shape, dtype=torch.float32, device=device)
        for m, index in pieces:
            out[index] = get(m).to(device)
    return out


def _copies_per_step(trees: dict, dtype):
    """`on(key, device)`: position `key`'s masters cast to `dtype` (once a
    step, on their own device) and copied to `device` (once a step per
    device; the tree itself where the device is its own). Both are
    differentiable, so the gradients of every copy sum into the f32
    masters."""
    cast = trees if dtype == torch.float32 else {
        k: _tree_map(lambda a: a.to(dtype), t) for k, t in trees.items()}
    copies = {}

    def on(key, device):
        if (key, device) not in copies:
            copies[key, device] = _tree_map(lambda a: a.to(device),
                                            cast[key])
        return copies[key, device]
    return on


def _tree_map(fn, tree):
    """fn applied to every tensor of a parameter tree of dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# the kinds of message of a step over processes (`_Span.tags`)
_HOP, _F_ATTN, _G_ATTN, _F_FF, _G_FF, _KV = range(6)


class _Where(NamedTuple):
    """One layer of one microbatch of one stage over processes: the
    positions' devices (None where another process's) and processes,
    [c][j] by seq shard and model position, this process, the step's
    `cluster.Link`, the message tags with this layer's coordinates set,
    and the (shape, dtype) of a home activation."""
    devs: list
    owners: list
    rank: int
    link: object
    tag: Callable
    act: tuple


def _tp_f(y, devices, where=None, c=0, kind=_F_ATTN):
    """Megatron's `f` (reference `_tp_f`): the layer-normed input, one
    differentiable copy on each model position's device. Forward the
    identity; backward autograd sums the copies' cotangents, the
    reference's psum over the model axis.

    Over processes (`where`, seq shard c) an entry is None where another
    process owns the position: the home position (model 0) sends y to
    each such position and adds the cotangents in model-position order
    (`Link.copy_out`); a position away from home receives y."""
    if where is None:
        return [y.to(d) for d in devices]
    tp = len(devices)
    home = where.owners[c][0]
    mine = [j for j in range(tp) if where.owners[c][j] == where.rank]
    out = [None] * tp
    if where.rank == home:
        remote = [(j, where.owners[c][j], where.tag(kind=kind, model=j,
                                                    shard=c))
                  for j in range(tp) if j not in mine]
        if not remote:
            return [y.to(d) for d in devices]
        copies = where.link.copy_out(y, [(j, devices[j]) for j in mine],
                                     remote)
    else:
        copies = where.link.messages(recvs=[
            (*where.act, devices[j], home, where.tag(kind=kind, model=j,
                                                     shard=c))
            for j in mine]) if mine else []
    for j, t in zip(mine, copies):
        out[j] = t
    return out


def _tp_g(parts, device, where=None, c=0, kind=_G_ATTN):
    """Megatron's `g` (reference `_tp_g`): the model positions' partial
    outputs summed on `device`, the home position. Backward each part
    receives the sum's cotangent as it is, the reference's identity (no
    second psum, so no gradient counts tp times).

    Over processes a part of another process's position is None: the
    home adds the parts in model-position order, those of other
    processes received (`Link.sum_in`), and returns the sum; a process
    away from home sends its parts and returns None."""
    if where is None or all(o == where.rank for o in where.owners[c]):
        out = parts[0].to(device)
        for p in parts[1:]:
            out = out + p.to(device)
        return out
    home = where.owners[c][0]
    if where.rank == home:
        like = parts[0]
        return where.link.sum_in(
            [p if where.owners[c][j] == where.rank else
             (where.owners[c][j], where.tag(kind=kind, model=j, shard=c),
              tuple(like.shape), like.dtype)
             for j, p in enumerate(parts)], device)
    sends = [(p, home, where.tag(kind=kind, model=j, shard=c))
             for j, p in enumerate(parts) if p is not None]
    if sends:
        where.link.messages(sends=sends)
    return None


def _attend(qs, ks, vs, attention: str, where=None, j=0):
    """Causal attention of the seq shards of (mb, S_loc, H, D) q/k/v, one
    microbatch at one model position: with one shard, the flash kernels
    one sequence at a time or dense attention over the batch; with
    cp > 1, ring attention over the shards for each sequence (flash stats
    blocks for "flash"). Returns the shards' outputs. Over processes
    (`where`, model position j) a shard of another process's position is
    None, and its ring runs through `where.link`."""
    mine = [c for c, q in enumerate(qs) if q is not None]
    if not mine:
        return [None] * len(qs)
    if len(qs) == 1:
        q, k, v = qs[0], ks[0], vs[0]
        if attention == "flash":
            return [torch.stack([flash_attention(q[b], k[b], v[b],
                                                 causal=True)
                                 for b in range(q.shape[0])])]
        return [reference_attention(q, k, v, causal=True)]
    scale = 1.0 / math.sqrt(qs[mine[0]].shape[-1])

    def ring(b):
        if where is None:
            return None
        return RingLink(where.link, tuple(o[j] for o in where.owners),
                        lambda pos, step: where.tag(kind=_KV, seqb=b,
                                                    model=j, shard=pos,
                                                    step=step))

    def pick(ts, b):
        return [None if t is None else t[b] for t in ts]
    per_seq = [_ring_attention_sharded(
        pick(qs, b), pick(ks, b), pick(vs, b), causal=True, scale=scale,
        block_impl="flash" if attention == "flash" else "dense",
        ring=ring(b))
        for b in range(qs[mine[0]].shape[0])]
    return [None if qs[c] is None else
            torch.stack([outs[c] for outs in per_seq])
            for c in range(len(qs))]


def _block_attn(xs, lps, h: int, dh: int, attention: str = "dense",
                where=None):
    """Attention sublayer of one transformer block on the seq shards
    (mb, S_loc, d) of one microbatch, each on its home position.
    lps[c][j] is layer parameters on the device of (seq shard c, model
    position j), j's Megatron slices (ln1 at j = 0): ln1 -> f -> each
    position's h local heads of q, k, v -> (ring/flash/dense) causal
    attention over the seq shards -> its rows of wo -> g -> residual
    add. Over processes (`where`) an x or lp of another process's
    position is None, and so is the output of a home that is."""
    tp = len(lps[0])
    devs = (where.devs if where is not None else
            [[lp["wq"].device for lp in lp_c] for lp_c in lps])
    qkv = [[(None, None, None)] * len(lps) for _ in range(tp)]  # [j][c]
    for c, (x, lp_c) in enumerate(zip(xs, lps)):
        y = None if x is None else _layer_norm(x, lp_c[0]["ln1"])
        for j, (yj, lp) in enumerate(zip(
                _tp_f(y, devs[c], where, c, _F_ATTN), lp_c)):
            if yj is not None:
                mb, seq, _ = yj.shape
                qkv[j][c] = [(yj @ lp[w]).reshape(mb, seq, h, dh)
                             for w in ("wq", "wk", "wv")]
    a = [_attend(*(list(t) for t in zip(*qkv_j)), attention, where, j)
         for j, qkv_j in enumerate(qkv)]   # [j][c]
    out = []
    for c, (x, lp_c) in enumerate(zip(xs, lps)):
        parts = [None if a[j][c] is None else
                 a[j][c].reshape(a[j][c].shape[0], a[j][c].shape[1],
                                 h * dh) @ lp["wo"]
                 for j, lp in enumerate(lp_c)]
        g = _tp_g(parts, None if x is None else x.device, where, c, _G_ATTN)
        out.append(None if x is None else x + g)
    return out


def _block_ff(x, lps, where=None, c=0):
    """Feed-forward sublayer on a home position, lps[j] the layer's
    parameters at model position j: ln2 -> f -> each position's slice of
    the tanh-GELU MLP -> g -> residual add, with b2 added after the sum,
    as the reference adds it (inside, it would count tp times). Over
    processes (`where`, seq shard c) as `_block_attn`."""
    devs = (where.devs[c] if where is not None else
            [lp["w1"].device for lp in lps])
    y = None if x is None else _layer_norm(x, lps[0]["ln2"])
    parts = [None if yj is None else
             F.gelu(yj @ lp["w1"] + lp["b1"], approximate="tanh") @ lp["w2"]
             for yj, lp in zip(_tp_f(y, devs, where, c, _F_FF), lps)]
    g = _tp_g(parts, None if x is None else x.device, where, c, _G_FF)
    return None if x is None else x + g + lps[0]["b2"]


def _block(xs, lps, h: int, dh: int, attention: str = "dense", where=None):
    """One transformer block on the seq shards of one microbatch: the two
    sublayers, split so that remat can trade them apart
    (remat="save_attn")."""
    return [_block_ff(x, lp, where, c) for c, (x, lp) in enumerate(zip(
        _block_attn(xs, lps, h, dh, attention=attention, where=where),
        lps))]


class _Span:
    """A trainer's mesh over processes: the process of every position,
    the processes that hold a replica of each position key's masters
    (`replicas`), and the sums over them. `key_positions` maps each key
    to the positions (coordinate dicts) that compute with its masters."""

    def __init__(self, mesh, key_positions: dict):
        self.exchange = mesh.exchange
        self.rank, self.world = mesh.process_index, mesh.process_count
        self.replicas = {key: tuple(sorted({mesh.process_of(**p)
                                            for p in ps}))
                         for key, ps in key_positions.items()}
        groups = sorted({r for r in self.replicas.values() if len(r) > 1})
        self._group_tags = {r: cluster.MessageTags.SUM_TAGS + i
                            for i, r in enumerate(groups)}
        self._loss_tag = cluster.MessageTags.SUM_TAGS + len(groups)

    def canonical(self, key) -> bool:
        """Whether this process is the lowest that holds `key`."""
        return self.replicas[key][0] == self.rank

    def sum_grads(self, blocks: _Blocks) -> None:
        """Every replicated master's gradient summed over the processes
        that hold it, in rank order: one message a peer for each set of
        processes, the masters in the full tree's order (a master with no
        gradient adds zeros)."""
        groups = {}
        for layout in blocks.layout:
            for key, _, m in layout:
                if m is not None and len(self.replicas[key]) > 1:
                    groups.setdefault(self.replicas[key], []).append(m)
        for ranks in sorted(groups):
            ms = groups[ranks]
            dev = ms[0].device
            flat = torch.cat([(torch.zeros_like(m) if m.grad is None
                               else m.grad).reshape(-1).to(dev)
                              for m in ms])
            total = self.exchange.ordered_sum(flat, ranks,
                                              self._group_tags[ranks])
            for m, g in zip(ms, total.split([m.numel() for m in ms])):
                m.grad = g.reshape(m.shape).to(m.device)

    def loss_sum(self, total):
        """Every process's share of the loss summed in rank order: the
        same float on each."""
        return self.exchange.ordered_sum(total, range(self.world),
                                         self._loss_tag)


def _local_or_none(mesh, **coords):
    return mesh.device_at(**coords) if mesh.is_local(**coords) else None


def _leaves(tree):
    """The tensors of a parameter tree (dicts and lists), in order."""
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def _mesh_sizes(mesh, n_heads: int, d_ff: int, n_layers=None) -> tuple:
    """(pipe, model, seq) sizes of a mesh, checked as the reference checks
    them: the layers divide over the pipe axis (when `n_layers` is
    given), the heads and d_ff over the model axis."""
    shape = mesh.shape
    pp, tp = shape.get(PIPE_AXIS, 1), shape.get(MODEL_AXIS, 1)
    if n_layers is not None and n_layers % pp:
        raise ValueError(
            f"n_layers ({n_layers}) must divide by the pipe axis ({pp}) "
            f"so every stage holds the same layer count")
    if n_heads % tp:
        raise ValueError(
            f"n_heads ({n_heads}) must divide by the model axis ({tp})")
    if d_ff % tp:
        raise ValueError(
            f"d_ff ({d_ff}) must divide by the model axis ({tp})")
    return pp, tp, shape.get(SEQ_AXIS, 1)


def _check_device(device, first):
    if device is not None and torch.device(device) != first:
        raise ValueError(f"device={device!r} is not the mesh's first "
                         f"device {first}, where the parameters live")


class PipelinedLMTrainer:
    """Causal LM trainer: loss = t.step(tokens), (B, S) int tokens with
    B % (dp * n_microbatches) == 0 and S % cp == 0.

    The reference's parameters, plus `device` (None = the card). With
    mesh=None it trains on `device`. A mesh (`parallel.grid_mesh`) must
    have the "data" and "pipe" axes and may have "model" and "seq", as
    the reference's 2D/3D/4D meshes do: batch rows shard over data, the
    layers over pipe (GPipe), the heads and d_ff over model (Megatron),
    the sequence over seq (ring attention). The embedding, positions and
    final norm live on the mesh's first device; `device`, if given, must
    be that device. A mesh that spans processes trains across them (the
    module docstring): every process passes the same tokens and returns
    the same loss; `device` names this process's first device."""

    def __init__(self, vocab_size: int, mesh=None, n_microbatches: int = 4,
                 d_model: int = 128, n_heads: int = 8, n_layers: int = 4,
                 d_ff: int = 256, max_len: int = 512, lr: float = 1e-3,
                 seed: int = 0, attention: str = "dense",
                 optimizer: str = "adam", compute_dtype: str = "float32",
                 remat: bool = False, device=None):
        """compute_dtype="bfloat16" trains mixed-precision: master weights
        and the optimizer state stay f32; every f32 master is cast to bf16
        once per step on its own position (a differentiable cast, so the
        gradients reach the f32 masters) while layer norm, softmax and the
        loss compute in f32, and the logits come from the bf16 operands
        with f32 accumulation.

        remat=True (= "full") checkpoints each block, so the backward
        recomputes its activations (the flash forward runs twice per layer
        per step); remat="save_attn" checkpoints only the FF sublayer and
        keeps the attention sublayer's residuals (q, k, v, out, lse), so
        the flash forward runs once per layer and model position."""
        if attention not in ("dense", "flash"):
            raise ValueError("attention must be dense|flash")
        if optimizer not in ("adam", "sgd"):
            raise ValueError("optimizer must be adam|sgd")
        # isinstance, not `in (True, False, ...)`: ints equal bools under
        # tuple membership, so remat=1 would silently mean full remat
        if not (isinstance(remat, bool) or remat in ("full", "save_attn")):
            raise ValueError("remat must be bool|'full'|'save_attn'")
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError("compute_dtype must be float32|bfloat16")
        self._span = None
        if mesh is None:
            self.device = resolve_device(device)
            self.dp = self.n_stages = self.tp = self.cp = 1
            self._devs = self._owners = [[[[self.device]]]]
        else:
            for axis in (DATA_AXIS, PIPE_AXIS):
                if axis not in mesh.shape:
                    raise ValueError(f"PipelinedLMTrainer's mesh needs a "
                                     f"{axis!r} axis; got axes "
                                     f"{mesh.axis_names}")
            self.n_stages, self.tp, self.cp = _mesh_sizes(
                mesh, n_heads, d_ff, n_layers)
            self.dp = mesh.shape[DATA_AXIS]
            self.device = mesh.devices.flat[0]
            _check_device(device, self.device)
            grid = [[[[dict(data=d, pipe=s, model=j, seq=c)
                       for c in range(self.cp)] for j in range(self.tp)]
                     for s in range(self.n_stages)] for d in range(self.dp)]
            # _devs[d][s][j][c]: the device of (data d, pipe s, model j,
            # seq c), where that position computes (None: another
            # process's); _owners[d][s][j][c] its process
            self._devs = _nest(lambda p: _local_or_none(mesh, **p), grid)
            self._owners = _nest(lambda p: mesh.process_of(**p), grid)
        self.mesh = mesh
        self.n_microbatches = n_microbatches
        self.attention = attention
        self.remat = remat
        self.compute_dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
                              else torch.float32)

        raw = init_transformer(vocab_size, d_model, n_heads, n_layers, d_ff,
                               max_len, seed)
        self.meta = raw.pop("meta")
        per_stage = self._per_stage = n_layers // self.n_stages
        dp, P, cp = self.dp, self.n_stages, self.cp
        # the positions that compute with each key's masters: a stage's
        # model-j blocks at every data and seq coordinate, the shared
        # embed/pos/final_ln at the home positions (model 0) of the first
        # and the last stage
        key_positions = {"shared": [(d, s, 0, c) for d in range(dp)
                                    for s in sorted({0, P - 1})
                                    for c in range(cp)]}
        for s in range(P):
            for j in range(self.tp):
                key_positions[s, j] = [(d, s, j, c) for d in range(dp)
                                       for c in range(cp)]
        if mesh is not None and mesh.process_count > 1:
            self._span = _Span(mesh, {
                k: [dict(data=d, pipe=s, model=j, seq=c)
                    for d, s, j, c in ps]
                for k, ps in key_positions.items()})

        def home_of(key):
            # a key's masters live on the device of the first of its
            # positions this process owns
            return next((self._devs[d][s][j][c]
                         for d, s, j, c in key_positions[key]
                         if self._devs[d][s][j][c] is not None), None)

        def placement(path, shape):
            if path[0] != "layers":
                yield "shared", home_of("shared"), ()
                return
            for s in range(self.n_stages):
                lead = (slice(s * per_stage, (s + 1) * per_stage),)
                for j in range(self.tp):
                    index = _megatron_index(path[1], shape, j, self.tp,
                                            lead)
                    if index is not None:
                        yield (s, j), home_of((s, j)), index
        self._blocks = _Blocks({
            "layers": _stack_layers(raw["layers"]),   # leaves (L, ...)
            "embed": raw["embed"], "pos": raw["pos"],
            "final_ln": raw["final_ln"]}, placement, self._span)
        masters = self._blocks.masters()
        # sgd exists for gradient-parity testing: Adam is invariant to a
        # uniform scaling of the gradients, SGD is not. Both act element
        # by element, so the blocks update as the whole leaves would
        self._opt = (torch.optim.Adam(masters, lr=lr, betas=(0.9, 0.999),
                                      eps=1e-8)
                     if optimizer == "adam" else torch.optim.SGD(masters,
                                                                 lr=lr))

    @property
    def params(self) -> dict:
        """The parameters in the reference's layout, (L, ...) stacked
        layer leaves: a leaf held whole is its master, a cut one a
        detached tensor on the first device assembled from its blocks.
        Over processes a collective (every process must read it): the
        other processes' blocks come as detached copies."""
        return self._blocks.tree(self.device)

    def position_params(self, pipe: int = 0, model: int = 0) -> dict:
        """The layer masters that position (pipe, model) holds, e.g. wq
        of shape (L / pipe, d, d / model); ln1, ln2 and b2 at model 0.
        Over processes a collective: another process's come as detached
        copies."""
        return self._blocks.key_tree((pipe, model), self.device)["layers"]

    def _tags(self, tokens) -> cluster.MessageTags:
        """The message tags of one step over processes."""
        b_loc = tokens.shape[0] // self.dp
        return cluster.MessageTags(
            kind=6, data=self.dp, micro=self.n_microbatches,
            seqb=b_loc // self.n_microbatches, stage=self.n_stages,
            layer=self._per_stage, model=self.tp, shard=self.cp,
            step=self.cp)

    def _loss(self, tokens, link=None):
        """The reference's `device_loss` for every position, summed: per
        data shard, the GPipe ticks over the stages, a masked sum of the
        next-token NLL over its microbatches, taken in order on the last
        stage; returns (that sum, its divisor): the count of positions
        with a target times the data shards (the mean over them).

        Over processes (`link`, this step's `cluster.Link`) this process
        computes its own positions and sums its own terms; the stage hop
        to another process's position is a message."""
        on = _copies_per_step(self._blocks.trees, self.compute_dtype)
        n_heads, d = self.meta["n_heads"], self.meta["d_model"]
        dh = d // n_heads
        h_loc = n_heads // self.tp
        M, dp, P, tp, cp = (self.n_microbatches, self.dp, self.n_stages,
                            self.tp, self.cp)
        per_stage = self._per_stage
        b, seq = tokens.shape
        b_loc, s_loc = b // dp, seq // cp
        mb = b_loc // M
        tags = None if link is None else link.tags

        # the messages of a checkpointed region are kept for its recompute
        recomputable = (contextlib.nullcontext if link is None
                        else link.recomputable)

        def block(xs, lps, where):
            if self.remat == "save_attn":
                xs = _block_attn(xs, lps, h_loc, dh, self.attention, where)
                with recomputable():
                    return [checkpoint(_block_ff, x, lp, where, c,
                                       use_reentrant=False)
                            if x is not None
                            or any(p is not None for p in lp) else None
                            for c, (x, lp) in enumerate(zip(xs, lps))]
            if self.remat:
                with recomputable():
                    return checkpoint(_block, xs, lps, h_loc, dh,
                                      self.attention, where,
                                      use_reentrant=False)
            return _block(xs, lps, h_loc, dh, self.attention, where)

        def layer_at(i):
            return lambda a: a[i]

        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for di, devs in enumerate(self._devs):
            # home[s][c]: where stage s runs its replicated work for seq
            # shard c (model position 0); None: another process's
            home = [[devs[s][0][c] for c in range(cp)] for s in range(P)]
            rows = tokens[di * b_loc:(di + 1) * b_loc]

            def shard(c):   # (M, mb, S_loc) token shard c
                return rows[:, c * s_loc:(c + 1) * s_loc].reshape(M, mb,
                                                                  s_loc)
            mbs = [None if dev is None else shard(c).to(dev)
                   for c, dev in enumerate(home[0])]
            # next-token targets by one GLOBAL position: the last local
            # position's target is the next seq shard's first token; the
            # globally last position has none and is masked
            tgts = [None if dev is None else
                    torch.cat([shard(c)[:, :, 1:],
                               shard((c + 1) % cp)[:, :, :1]], dim=2).to(dev)
                    for c, dev in enumerate(home[-1])]
            masks = [(torch.arange(s_loc, device=dev) != s_loc - 1).float()
                     if c == cp - 1 and dev is not None else None
                     for c, dev in enumerate(home[-1])]
            first = [None if dev is None else on("shared", dev)
                     for dev in home[0]]
            last = [None if dev is None else on("shared", dev)
                    for dev in home[-1]]
            # stage_lps[s][c][j]: stage s's layers at (seq c, model j)
            stage_lps = [[[None if devs[s][j][c] is None else
                           on((s, j), devs[s][j][c])["layers"]
                           for j in range(tp)] for c in range(cp)]
                         for s in range(P)]
            acts = [None] * M    # each microbatch's shards between stages
            for t in range(M + P - 1):
                for s in range(P):
                    m = t - s
                    if not 0 <= m < M:
                        continue             # a bubble computes nothing
                    xs = [None] * cp
                    if any(lp is not None for row in stage_lps[s]
                           for lp in row):
                        if s == 0:
                            xs = [None if pc is None else
                                  pc["embed"][mbs[c][m]]
                                  + pc["pos"][c * s_loc:(c + 1) * s_loc]
                                  for c, pc in enumerate(first)]
                        else:
                            xs = acts[m]
                        for i in range(per_stage):
                            where = None if link is None else _Where(
                                [[devs[s][j][c] for j in range(tp)]
                                 for c in range(cp)],
                                [[self._owners[di][s][j][c]
                                  for j in range(tp)] for c in range(cp)],
                                self._span.rank, link,
                                functools.partial(tags, data=di, micro=m,
                                                  stage=s, layer=i),
                                ((mb, s_loc, d), self.compute_dtype))
                            xs = block(xs, [[None if lp is None else
                                             _tree_map(layer_at(i), lp)
                                             for lp in row]
                                            for row in stage_lps[s]],
                                       where)
                    if s < P - 1:
                        # the hop to stage s + 1
                        acts[m] = self._hop(xs, home[s], home[s + 1], di, m,
                                            s, link, (mb, s_loc, d))
                        continue
                    acts[m] = None
                    for c, (x, pc) in enumerate(zip(xs, last)):
                        if x is None:
                            continue
                        z = _layer_norm(x, pc["final_ln"])
                        # tied softmax head: bf16 operands, f32
                        # accumulation. torch's bf16 matmul would round
                        # the logits to bf16; the f32 upcast of both
                        # operands keeps every product exact and sums in
                        # f32
                        logits = z.float() @ pc["embed"].float().T
                        logp = torch.log_softmax(logits, dim=-1)
                        nll = -logp.gather(-1, tgts[c][m][..., None])[..., 0]
                        if masks[c] is not None:
                            nll = nll * masks[c]
                        total = total + nll.sum().to(self.device)
        return total, (M * mb * (s_loc * cp - 1), dp)

    def _hop(self, xs, src, dst, di, m, s, link, shape):
        """Stage s's outputs of microbatch m to stage s + 1's home
        positions: `.to` within a process, a message between two."""
        if link is None:
            return [x.to(dev) for x, dev in zip(xs, dst)]
        out = [None] * len(xs)
        sends, recvs = [], []
        for c, (x, a, b) in enumerate(zip(xs, src, dst)):
            tag = link.tags(kind=_HOP, data=di, micro=m, stage=s, shard=c)
            if a is not None and b is not None:
                out[c] = x.to(b)
            elif a is not None:
                sends.append((x, self._owners[di][s + 1][0][c], tag))
            elif b is not None:
                recvs.append((c, (shape, self.compute_dtype, b,
                                  self._owners[di][s][0][c], tag)))
        if sends or recvs:
            got = link.messages(sends, [r for _, r in recvs])
            for (c, _), t in zip(recvs, got):
                out[c] = t
        return out

    def _check_batch(self, tokens) -> None:
        B = tokens.shape[0]
        if B % (self.dp * self.n_microbatches):
            raise ValueError(
                f"batch {B} must divide by dp*microbatches = "
                f"{self.dp * self.n_microbatches}")
        if tokens.shape[1] % self.cp:
            raise ValueError(
                f"sequence length {tokens.shape[1]} must divide by the "
                f"seq axis ({self.cp})")

    def _update(self, tokens):
        """One optimizer update; returns the loss as a device scalar."""
        return _update(self, tokens)

    def _to_device(self, tokens):
        return torch.as_tensor(np.asarray(tokens), device=self.device).long()

    def step(self, tokens: np.ndarray) -> float:
        """One update; returns the batch loss (before the update)."""
        self._check_batch(tokens)
        return float(self._update(self._to_device(tokens)))

    def run(self, tokens: np.ndarray, n_steps: int) -> float:
        """n_steps chained updates on the same batch with ONE host sync, at
        the end; returns the last step's loss."""
        self._check_batch(tokens)
        n_steps = operator.index(n_steps)   # 2.9 must raise, not run 2
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        tok = self._to_device(tokens)
        for _ in range(n_steps):
            loss = self._update(tok)
        return float(loss)

    def save_checkpoint(self, directory: str, step: int) -> None:
        """Params and optimizer state, gathered into the reference's
        (L, ...) leaves, as checkpoint `step` of `directory`
        (`lm_training.save_lm_checkpoint`; over processes a collective:
        the first process writes, then every process meets at a
        barrier)."""
        from .lm_training import save_lm_checkpoint
        save_lm_checkpoint(directory, step, self.params, self._opt,
                           self.meta, self._blocks)

    def restore_checkpoint(self, directory: str, step: int = None) -> int:
        """Load params and optimizer state from the latest (or the given)
        step into this trainer's blocks, in place, whatever mesh wrote it;
        returns the step loaded. A differently seeded trainer continues
        the saved trajectory. Over processes every process reads the file
        and takes its own blocks (a collective)."""
        from .lm_training import restore_lm_checkpoint
        return restore_lm_checkpoint(directory, step, self.params,
                                     self._opt, self.meta, self._blocks)


def _update(trainer, tokens):
    """One optimizer update of either LM trainer (`_loss` returns the sum
    of its terms and the divisors); returns the loss as a device scalar.

    Over processes: the step's messages ride one `cluster.Link`, each
    process backpropagates its own share of the loss from the chain's
    last token, waits for its sends, sums the replicated masters'
    gradients in rank order (`_Span.sum_grads`) and steps; the returned
    loss is every process's share summed in rank order."""
    trainer._opt.zero_grad(set_to_none=True)
    span = trainer._span
    if span is None:
        total, (n, dp) = trainer._loss(tokens)
        loss = total / n / dp
        loss.backward()
        trainer._opt.step()
        return loss.detach()
    link = cluster.Link(span.exchange, trainer._tags(tokens), trainer.device)
    total, (n, dp) = trainer._loss(tokens, link)
    link.join(total / n / dp).backward()
    link.finish()
    span.sum_grads(trainer._blocks)
    trainer._opt.step()
    return span.loss_sum(total.detach()) / n / dp


def _nest(fn, tree):
    """fn of every leaf of nested lists, the nesting kept."""
    if isinstance(tree, list):
        return [_nest(fn, t) for t in tree]
    return fn(tree)


def _stack_layers(layers: list) -> dict:
    """List of per-layer param dicts -> one dict with (L, ...) leaves."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layers([lp[k] for lp in layers]) for k in first}
    return np.stack(layers)
