"""Causal LM training with dense attention on one device (port of
`mmlspark_tpu/models/dnn/lm_training.py`'s `_lm_loss` and
`ShardedLMTrainer`, restricted to one device).

The reference lays the parameters over a dp x tp mesh and lets XLA insert
the collectives; on one device that is one Adam step of the mean
next-token cross-entropy of `transformer_apply` (causal, dense). It is
the reference's own oracle for `PipelinedLMTrainer`.

Not ported yet: a mesh (ROADMAP Queue 1 item 15), `run_stream` with its
prefetcher and supervisor (item 17) and checkpoints (item 11).
"""
from __future__ import annotations

import operator

import numpy as np
import torch

from ...device import resolve_device
from .pp_training import CHECKPOINT_TODO, MESH_TODO, _leaves
from .transformer import init_transformer, params_from_numpy, \
    transformer_apply

RUN_STREAM_TODO = ("ShardedLMTrainer.run_stream (prefetching ingest and "
                   "supervised checkpoints) is not ported yet: ROADMAP "
                   "Queue 1 item 17")


def _lm_loss(params, meta, tokens):
    """Mean next-token cross-entropy for a (B, S) batch (causal): the
    forward is `transformer_apply`, the head the tied embedding."""
    emb = transformer_apply({**params, "meta": meta}, tokens, causal=True)
    logits = emb @ params["embed"].T
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return nll.mean()


class ShardedLMTrainer:
    """Causal LM trainer with dense attention and Adam on one device:
    loss = t.step(tokens), (B, S) int tokens. The reference's parameters,
    plus `device` (None = the card); `mesh` must be None."""

    def __init__(self, vocab_size: int, mesh=None, d_model: int = 128,
                 n_heads: int = 8, n_layers: int = 2, d_ff: int = 256,
                 max_len: int = 512, lr: float = 1e-3, seed: int = 0,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(MESH_TODO)
        if d_model % n_heads:
            raise ValueError(
                f"d_model ({d_model}) must divide by n_heads ({n_heads})")
        self.device = resolve_device(device)
        raw = init_transformer(vocab_size, d_model, n_heads, n_layers, d_ff,
                               max_len, seed)
        self.meta = raw.pop("meta")
        self.params = params_from_numpy(raw, self.device)
        leaves = list(_leaves(self.params))
        for a in leaves:
            a.requires_grad_(True)
        self._opt = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)

    def _update(self, tokens):
        self._opt.zero_grad(set_to_none=True)
        loss = _lm_loss(self.params, self.meta, tokens)
        loss.backward()
        self._opt.step()
        return loss.detach()

    def _to_device(self, tokens):
        return torch.as_tensor(np.asarray(tokens), device=self.device).long()

    def step(self, tokens: np.ndarray) -> float:
        """One Adam update; returns the batch loss (before the update)."""
        return float(self._update(self._to_device(tokens)))

    def run(self, tokens: np.ndarray, n_steps: int) -> float:
        """n_steps chained updates on the same batch with ONE host sync, at
        the end; returns the last step's loss."""
        n_steps = operator.index(n_steps)
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        tok = self._to_device(tokens)
        for _ in range(n_steps):
            loss = self._update(tok)
        return float(loss)

    def run_stream(self, batches, *args, **kwargs) -> list:
        raise NotImplementedError(RUN_STREAM_TODO)

    def save_checkpoint(self, directory: str, step: int) -> None:
        raise NotImplementedError(CHECKPOINT_TODO)

    def restore_checkpoint(self, directory: str, step: int = None) -> int:
        raise NotImplementedError(CHECKPOINT_TODO)
