"""Causal LM training, on one device or over a mesh's data and seq axes
(port of `mmlspark_tpu/models/dnn/pp_training.py`).

The reference's `PipelinedLMTrainer` runs a GPipe schedule in one
`shard_map` over a mesh that may compose data, pipe, tensor and sequence
parallelism. This module ports its one-stage schedule (the microbatches
in order) and the data and seq axes: the same blocks (`_block_attn`,
`_block_ff`, `_block`), the same loss (next-token targets across
sequence shards, the globally last position masked, a masked sum over
the microbatches divided by M * mb * (S_loc * cp - 1), the mean over
data shards), bf16 mixed precision with f32 master weights and optimizer
state, `remat` through `torch.utils.checkpoint`, and attention="flash"
through the flash kernels with their backward.

With a seq axis of cp > 1 positions the sequence is cut into cp shards
and attention is ring attention over them (`parallel/ring_attention.
_ring_attention_sharded`, the flash kernel's stats form for
attention="flash"). One process drives every (data, seq) shard
(`parallel/mesh.py`): the parameters live once, on the mesh's first
device, and each shard computes with a differentiable `.to(its device)`
copy, the identity where the device is the same, so autograd's sum over
the shards is the reference's psum over seq and its mean over data. The
flash kernels take one (S, H, D) sequence, so a microbatch's sequences
are looped over inside the attention sublayer (ROADMAP Queue 1 item 25:
a batched kernel).

Not ported yet: pipe and model axes of size > 1 (the GPipe schedule and
the Megatron f/g operators, ROADMAP Queue 1 item 15) and checkpoints
(items 11 and 22).
"""
from __future__ import annotations

import math
import operator

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from ...ops.flash_attention import flash_attention
from ...parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS
from ...parallel.ring_attention import (_ring_attention_sharded,
                                        reference_attention)
from .transformer import _layer_norm, init_transformer, params_from_numpy

PIPE_TP_TODO = ("pipe and model axes of size > 1 (the GPipe schedule and "
                "the Megatron f/g operators) are not ported yet: ROADMAP "
                "Queue 1 item 15; the data and seq axes are")
CHECKPOINT_TODO = ("LM trainer checkpoints are not ported yet: ROADMAP "
                   "Queue 1 items 11 and 22")


def _stack_layers(layers: list) -> dict:
    """List of per-layer param dicts -> one dict with (L, ...) leaves."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layers([lp[k] for lp in layers]) for k in first}
    return np.stack(layers)


def _tree_map(fn, tree):
    """fn applied to every tensor of a parameter tree of dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _attend(qs, ks, vs, attention: str):
    """Causal attention of the seq shards of (mb, S_loc, H, D) q/k/v, one
    microbatch: with one shard, the flash kernels one sequence at a time
    or dense attention over the batch; with cp > 1, ring attention over
    the shards for each sequence (flash stats blocks for "flash"). Returns
    the shards' outputs."""
    if len(qs) == 1:
        q, k, v = qs[0], ks[0], vs[0]
        if attention == "flash":
            return [torch.stack([flash_attention(q[b], k[b], v[b],
                                                 causal=True)
                                 for b in range(q.shape[0])])]
        return [reference_attention(q, k, v, causal=True)]
    scale = 1.0 / math.sqrt(qs[0].shape[-1])
    per_seq = [_ring_attention_sharded(
        [q[b] for q in qs], [k[b] for k in ks], [v[b] for v in vs],
        causal=True, scale=scale,
        block_impl="flash" if attention == "flash" else "dense")
        for b in range(qs[0].shape[0])]
    return [torch.stack([outs[c] for outs in per_seq])
            for c in range(len(qs))]


def _block_attn(xs, lps, h: int, dh: int, attention: str = "dense"):
    """Attention sublayer of one transformer block on the seq shards
    (mb, S_loc, d) of one microbatch, each with its device's copy of the
    layer's parameters: ln1 -> qkv -> (ring/flash/dense) causal attention
    -> wo -> residual add."""
    qkv = []
    for x, lp in zip(xs, lps):
        mb, seq, _ = x.shape
        y = _layer_norm(x, lp["ln1"])
        qkv.append([(y @ lp[w]).reshape(mb, seq, h, dh)
                    for w in ("wq", "wk", "wv")])
    a = _attend(*(list(t) for t in zip(*qkv)), attention)
    return [x + ai.reshape(x.shape[0], x.shape[1], h * dh) @ lp["wo"]
            for x, ai, lp in zip(xs, a, lps)]


def _block_ff(x, lp):
    """Feed-forward sublayer: ln2 -> tanh-GELU MLP -> residual add, with
    b2 added after the MLP, as the reference adds it."""
    y = _layer_norm(x, lp["ln2"])
    ff = F.gelu(y @ lp["w1"] + lp["b1"], approximate="tanh") @ lp["w2"]
    return x + ff + lp["b2"]


def _block(xs, lps, h: int, dh: int, attention: str = "dense"):
    """One transformer block on the seq shards of one microbatch: the two
    sublayers, split so that remat can trade them apart
    (remat="save_attn")."""
    return [_block_ff(x, lp) for x, lp in zip(
        _block_attn(xs, lps, h, dh, attention=attention), lps)]


def _leaves(tree):
    """The tensors of a parameter tree (dicts and lists), in order."""
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


class PipelinedLMTrainer:
    """Causal LM trainer: loss = t.step(tokens), (B, S) int tokens with
    B % (dp * n_microbatches) == 0 and S % cp == 0.

    The reference's parameters, plus `device` (None = the card). With
    mesh=None it trains on `device`. A mesh (`parallel.grid_mesh`) must
    have the "data" and "pipe" axes and may have "model" and "seq", as
    the reference's 2D/3D/4D meshes do; data and seq may have any size
    (batch rows shard over data, the sequence over seq with ring
    attention), pipe and model only 1 (a larger one raises
    NotImplementedError naming ROADMAP item 15). The parameters live on
    the mesh's first device; `device`, if given, must be that device."""

    def __init__(self, vocab_size: int, mesh=None, n_microbatches: int = 4,
                 d_model: int = 128, n_heads: int = 8, n_layers: int = 4,
                 d_ff: int = 256, max_len: int = 512, lr: float = 1e-3,
                 seed: int = 0, attention: str = "dense",
                 optimizer: str = "adam", compute_dtype: str = "float32",
                 remat: bool = False, device=None):
        """compute_dtype="bfloat16" trains mixed-precision: master weights
        and the optimizer state stay f32; every f32 leaf is cast to bf16
        once per step (a differentiable cast, so the gradients reach the
        f32 masters) while layer norm, softmax and the loss compute in
        f32, and the logits come from the bf16 operands with f32
        accumulation.

        remat=True (= "full") checkpoints each block, so the backward
        recomputes its activations (the flash forward runs twice per layer
        per step); remat="save_attn" checkpoints only the FF sublayer and
        keeps the attention sublayer's residuals (q, k, v, out, lse), so
        the flash forward runs once per layer."""
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
        if mesh is None:
            self.device = resolve_device(device)
            self.dp, self.cp = 1, 1
            self._grid = [[self.device]]
        else:
            self._grid = self._mesh_grid(mesh)
            self.dp, self.cp = len(self._grid), len(self._grid[0])
            self.device = self._grid[0][0]
            if device is not None and torch.device(device) != self.device:
                raise ValueError(f"device={device!r} is not the mesh's first "
                                 f"device {self.device}, where the "
                                 f"parameters live")
        self.mesh = mesh
        self.n_microbatches = n_microbatches
        self.attention = attention
        self.remat = remat
        self.compute_dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
                              else torch.float32)

        raw = init_transformer(vocab_size, d_model, n_heads, n_layers, d_ff,
                               max_len, seed)
        self.meta = raw.pop("meta")
        self.params = params_from_numpy({
            "layers": _stack_layers(raw["layers"]),   # leaves (L, ...)
            "embed": raw["embed"], "pos": raw["pos"],
            "final_ln": raw["final_ln"]}, self.device)
        leaves = list(_leaves(self.params))
        for a in leaves:
            a.requires_grad_(True)
        # sgd exists for gradient-parity testing: Adam is invariant to a
        # uniform scaling of the gradients, SGD is not
        self._opt = (torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999),
                                      eps=1e-8)
                     if optimizer == "adam" else torch.optim.SGD(leaves,
                                                                 lr=lr))

    @staticmethod
    def _mesh_grid(mesh) -> list:
        """The (dp, cp) grid of devices that run the shards: the mesh's
        pipe and model coordinates at 0 (both must be of size 1)."""
        shape = mesh.shape
        for axis in (DATA_AXIS, PIPE_AXIS):
            if axis not in shape:
                raise ValueError(f"PipelinedLMTrainer's mesh needs a "
                                 f"{axis!r} axis; got axes {mesh.axis_names}")
        if shape[PIPE_AXIS] > 1 or shape.get(MODEL_AXIS, 1) > 1:
            raise NotImplementedError(PIPE_TP_TODO)
        cp = shape.get(SEQ_AXIS, 1)

        def at(d, c):
            idx = {DATA_AXIS: d, SEQ_AXIS: c}
            return mesh.devices[tuple(idx.get(a, 0)
                                      for a in mesh.axis_names)]
        return [[at(d, c) for c in range(cp)]
                for d in range(shape[DATA_AXIS])]

    def _loss(self, tokens):
        """The reference's `device_loss` for every (data, seq) shard,
        summed: per data shard, a masked sum of the next-token NLL over its
        microbatches, taken in order, divided by the count of positions
        with a target; then the mean over data shards."""
        p = self.params
        if self.compute_dtype != torch.float32:
            # one differentiable downcast per step
            p = _tree_map(lambda a: a.to(self.compute_dtype), p)
        # each shard's device computes with its own differentiable copy,
        # the tree itself where the device is the same (autograd sums the
        # copies' gradients back into the masters)
        on = {dev: _tree_map(lambda a, d=dev: a.to(d), p)
              for row in self._grid for dev in row}
        n_heads, d = self.meta["n_heads"], self.meta["d_model"]
        dh = d // n_heads
        n_layers = p["layers"]["wq"].shape[0]
        M, dp, cp = self.n_microbatches, self.dp, self.cp
        b, seq = tokens.shape
        b_loc, s_loc = b // dp, seq // cp
        mb = b_loc // M

        def block(xs, lps):
            if self.remat == "save_attn":
                xs = _block_attn(xs, lps, n_heads, dh, self.attention)
                return [checkpoint(_block_ff, x, lp, use_reentrant=False)
                        for x, lp in zip(xs, lps)]
            if self.remat:
                return checkpoint(_block, xs, lps, n_heads, dh,
                                  self.attention, use_reentrant=False)
            return _block(xs, lps, n_heads, dh, self.attention)

        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for di, devs in enumerate(self._grid):
            ps = [on[dev] for dev in devs]
            rows = tokens[di * b_loc:(di + 1) * b_loc]
            # (M, mb, S_loc) token shards, shard c on its device
            mbs = [rows[:, c * s_loc:(c + 1) * s_loc].reshape(M, mb, s_loc)
                   .to(dev) for c, dev in enumerate(devs)]
            # next-token targets by one GLOBAL position: the last local
            # position's target is the next seq shard's first token; the
            # globally last position has none and is masked
            tgts = [torch.cat([mbs[c][:, :, 1:],
                               mbs[(c + 1) % cp][:, :, :1].to(dev)], dim=2)
                    for c, dev in enumerate(devs)]
            masks = [(torch.arange(s_loc, device=dev) != s_loc - 1).float()
                     if c == cp - 1 else None for c, dev in enumerate(devs)]
            for m in range(M):
                xs = [pc["embed"][mbs[c][m]]
                      + pc["pos"][c * s_loc:(c + 1) * s_loc]
                      for c, pc in enumerate(ps)]
                for i in range(n_layers):
                    xs = block(xs, [_tree_map(lambda a: a[i], pc["layers"])
                                    for pc in ps])
                for c, (x, pc) in enumerate(zip(xs, ps)):
                    z = _layer_norm(x, pc["final_ln"])
                    # tied softmax head: bf16 operands, f32 accumulation.
                    # torch's bf16 matmul would round the logits to bf16;
                    # the f32 upcast of both operands keeps every product
                    # exact and sums in f32
                    logits = z.float() @ pc["embed"].float().T
                    logp = torch.log_softmax(logits, dim=-1)
                    nll = -logp.gather(-1, tgts[c][m][..., None])[..., 0]
                    if masks[c] is not None:
                        nll = nll * masks[c]
                    total = total + nll.sum().to(self.device)
        return total / (M * mb * (s_loc * cp - 1)) / dp

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
        self._opt.zero_grad(set_to_none=True)
        loss = self._loss(tokens)
        loss.backward()
        self._opt.step()
        return loss.detach()

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
        raise NotImplementedError(CHECKPOINT_TODO)

    def restore_checkpoint(self, directory: str, step: int = None) -> int:
        raise NotImplementedError(CHECKPOINT_TODO)
