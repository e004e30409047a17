"""Causal LM training on one device (port of
`mmlspark_tpu/models/dnn/pp_training.py`, restricted to one device).

The reference's `PipelinedLMTrainer` runs a GPipe schedule over a mesh
that may compose data, pipe, tensor and sequence parallelism. On one
device its schedule is one stage taking the microbatches in order, and
that is what this module ports: the same blocks (`_block_attn`,
`_block_ff`, `_block`), the same loss (next-token targets, the last
position masked, a masked sum over the microbatches divided by
M * mb * (S - 1)), bf16 mixed precision with f32 master weights and
optimizer state, `remat` through `torch.utils.checkpoint`, and
attention="flash" through the flash kernels with their backward. The
flash kernels take one (S, H, D) sequence, so the microbatch's sequences
are looped over inside the attention sublayer (ROADMAP Queue 1 item 25:
a batched kernel).

Not ported yet: a mesh and the collectives it needs (the Megatron f/g
operators, the pipe schedule, ring attention: ROADMAP Queue 1 item 15)
and checkpoints (items 11 and 22).
"""
from __future__ import annotations

import operator

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...device import resolve_device
from ...ops.flash_attention import flash_attention
from ...parallel.ring_attention import reference_attention
from .transformer import _layer_norm, init_transformer, params_from_numpy

MESH_TODO = ("a mesh (data/pipe/model/seq parallel LM training) needs "
             "torch.distributed and is not ported yet: ROADMAP Queue 1 "
             "item 15; mesh=None trains on one device")
CHECKPOINT_TODO = ("LM trainer checkpoints are not ported yet: ROADMAP "
                   "Queue 1 items 11 and 22")


def _stack_layers(layers: list) -> dict:
    """List of per-layer param dicts -> one dict with (L, ...) leaves."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack_layers([lp[k] for lp in layers]) for k in first}
    return np.stack(layers)


def _layer(tree, i: int):
    """Layer i of a stacked tree (differentiable indexing)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _attend(q, k, v, attention: str):
    """Causal attention of (mb, S, H, D) q/k/v: the flash kernels take one
    sequence at a time; dense attention takes the batch."""
    if attention == "flash":
        return torch.stack([flash_attention(q[b], k[b], v[b], causal=True)
                            for b in range(q.shape[0])])
    return reference_attention(q, k, v, causal=True)


def _block_attn(x, lp, h: int, dh: int, attention: str = "dense"):
    """Attention sublayer of one transformer block on (mb, S, d)
    sequences: ln1 -> qkv -> (flash/dense) causal attention -> wo ->
    residual add."""
    mb, seq, _ = x.shape
    y = _layer_norm(x, lp["ln1"])
    q = (y @ lp["wq"]).reshape(mb, seq, h, dh)
    k = (y @ lp["wk"]).reshape(mb, seq, h, dh)
    v = (y @ lp["wv"]).reshape(mb, seq, h, dh)
    a = _attend(q, k, v, attention)
    return x + a.reshape(mb, seq, h * dh) @ lp["wo"]


def _block_ff(x, lp):
    """Feed-forward sublayer: ln2 -> tanh-GELU MLP -> residual add, with
    b2 added after the MLP, as the reference adds it."""
    y = _layer_norm(x, lp["ln2"])
    ff = F.gelu(y @ lp["w1"] + lp["b1"], approximate="tanh") @ lp["w2"]
    return x + ff + lp["b2"]


def _block(x, lp, h: int, dh: int, attention: str = "dense"):
    """One transformer block: the two sublayers, split so that remat can
    trade them apart (remat="save_attn")."""
    return _block_ff(_block_attn(x, lp, h, dh, attention=attention), lp)


def _leaves(tree):
    """The tensors of a parameter tree (dicts and lists), in order."""
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


class PipelinedLMTrainer:
    """Causal LM trainer on one device: loss = t.step(tokens), (B, S) int
    tokens with B % n_microbatches == 0.

    The reference's parameters, plus `device` (None = the card). `mesh`
    must be None (one device); a mesh raises NotImplementedError naming
    ROADMAP item 15."""

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
        if mesh is not None:
            raise NotImplementedError(MESH_TODO)
        self.device = resolve_device(device)
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

    def _loss(self, tokens):
        """The reference's `device_loss` on one stage: a masked sum of the
        next-token NLL over the microbatches, taken in order, divided by
        the count of positions with a target."""
        p = self.params
        if self.compute_dtype != torch.float32:
            # one differentiable downcast per step
            def cast(node):
                if isinstance(node, dict):
                    return {k: cast(v) for k, v in node.items()}
                return node.to(self.compute_dtype)
            p = cast(p)
        n_heads, d = self.meta["n_heads"], self.meta["d_model"]
        dh = d // n_heads
        n_layers = p["layers"]["wq"].shape[0]
        M = self.n_microbatches
        b, seq = tokens.shape
        mb = b // M
        mbs = tokens.reshape(M, mb, seq)
        # next-token targets; the last position has none and is masked
        tgt_mbs = torch.cat([mbs[:, :, 1:], mbs[:, :, :1]], dim=2)
        pos_mask = (torch.arange(seq, device=tokens.device) != seq - 1
                    ).float()

        def block(x, lp):
            if self.remat == "save_attn":
                x = _block_attn(x, lp, n_heads, dh, self.attention)
                return checkpoint(_block_ff, x, lp, use_reentrant=False)
            if self.remat:
                return checkpoint(_block, x, lp, n_heads, dh,
                                  self.attention, use_reentrant=False)
            return _block(x, lp, n_heads, dh, self.attention)

        total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for m in range(M):
            x = p["embed"][mbs[m]] + p["pos"][:seq]
            for i in range(n_layers):
                x = block(x, _layer(p["layers"], i))
            z = _layer_norm(x, p["final_ln"])
            # tied softmax head: bf16 operands, f32 accumulation. torch's
            # bf16 matmul would round the logits to bf16; the f32 upcast
            # of both operands keeps every product exact and sums in f32
            logits = z.float() @ p["embed"].float().T
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, tgt_mbs[m][..., None])[..., 0]
            total = total + (nll * pos_mask).sum()
        return total / (M * mb * (seq - 1))

    def _check_batch(self, tokens) -> None:
        B = tokens.shape[0]
        if B % self.n_microbatches:
            raise ValueError(
                f"batch {B} must divide by dp*microbatches = "
                f"{self.n_microbatches}")

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
