"""Causal LM training with dense attention on one device (port of
`mmlspark_tpu/models/dnn/lm_training.py`'s `_lm_loss` and
`ShardedLMTrainer`, restricted to one device).

The reference lays the parameters over a dp x tp mesh and lets XLA insert
the collectives; on one device that is one Adam step of the mean
next-token cross-entropy of `transformer_apply` (causal, dense). It is
the reference's own oracle for `PipelinedLMTrainer`.

Step checkpoints of both LM trainers live here, as in the reference:
`save_lm_checkpoint` / `restore_lm_checkpoint` over `utils.checkpoint`'s
`CheckpointManager`, in the reference's payload (its `meta`, the params
by `payload.tree_to_payload`, and the optimizer's leaves in
`optax.adam`'s flatten order, count, mu..., nu..., which map to and from
`torch.optim.Adam`'s `step`, `exp_avg` and `exp_avg_sq`), so a checkpoint
written by either package restores in the other.

Not ported yet: a mesh (ROADMAP Queue 1 item 15) and `run_stream` with its
prefetcher and supervisor (item 17).
"""
from __future__ import annotations

import operator

import numpy as np
import torch

from ...device import resolve_device
from ...utils.checkpoint import CheckpointManager
from .payload import tree_from_payload, tree_to_payload
from .pp_training import _leaves
from .transformer import _flatten, init_transformer, params_from_numpy, \
    transformer_apply

MESH_TODO = ("ShardedLMTrainer on a mesh (the reference's GSPMD dp x tp "
             "layout) is not ported yet: ROADMAP Queue 1 item 15; mesh=None "
             "trains on one device, and PipelinedLMTrainer takes a mesh's "
             "data and seq axes")
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
        """Params and optimizer state as checkpoint `step` of
        `directory`."""
        save_lm_checkpoint(directory, step, self.params, self._opt,
                           self.meta)

    def restore_checkpoint(self, directory: str, step: int = None) -> int:
        """Load params and optimizer state from the latest (or the given)
        step into this trainer, in place; returns the step loaded."""
        return restore_lm_checkpoint(directory, step, self.params,
                                     self._opt, self.meta)


def _adam_leaves(params, opt) -> list:
    """The optimizer's state as `optax.adam`'s flattened state: [count,
    mu leaves..., nu leaves...] in the params' flatten order (zeros before
    the first step); [] for SGD, which keeps none."""
    if not isinstance(opt, torch.optim.Adam):
        return []
    leaves = _flatten(params)
    states = [opt.state.get(p, {}) for p in leaves]
    count = int(states[0]["step"]) if states[0] else 0
    mu = [s["exp_avg"] if s else torch.zeros_like(p)
          for p, s in zip(leaves, states)]
    nu = [s["exp_avg_sq"] if s else torch.zeros_like(p)
          for p, s in zip(leaves, states)]
    return [np.asarray(count, np.int32)] + mu + nu


def lm_state_payload(params, opt, meta) -> dict:
    """A trainer's live state as a checkpoint payload, the reference's
    layout: `meta`, the params with their treedef (prefix "p"), and the
    optimizer's leaves alone (prefix "o")."""
    payload = {"meta": dict(meta)}
    payload.update(tree_to_payload(params, "p"))
    payload.update(tree_to_payload(_adam_leaves(params, opt), "o",
                                   leaves_only=True))
    return payload


def save_lm_checkpoint(directory: str, step: int, params, opt,
                       meta) -> None:
    """Write the trainer's state as step `step` (shared by both
    trainers: one implementation, one on-disk format)."""
    CheckpointManager(directory).save(step, lm_state_payload(params, opt,
                                                             meta))


def restore_lm_checkpoint(directory: str, step, params, opt, meta) -> int:
    """Load step `step` (None: the newest readable one, past a torn or
    corrupt newest step) into the live params and optimizer; returns the
    step loaded."""
    mgr = CheckpointManager(directory)
    if step is None:
        payload, step = mgr.restore(with_step=True)
    else:
        payload = mgr.restore(step)
    lm_state_from_payload(payload, params, opt, meta)
    return step


def lm_state_from_payload(payload, params, opt, meta) -> None:
    """Apply a checkpoint payload to the live state in place: every param
    leaf copied into its tensor (the optimizer keeps its references), the
    optimizer's state rebuilt from `optax.adam`'s leaves. Refuses another
    model config ("different model") and another layout ("parameter
    leaves", shapes), as the reference does."""
    saved_meta = payload.get("meta")
    if saved_meta is not None and dict(saved_meta) != dict(meta):
        raise ValueError(
            f"checkpoint was saved with model config {saved_meta} but "
            f"this trainer has {dict(meta)} — resuming would "
            f"silently train a different model")
    live = _flatten(params)
    new = _flatten(tree_from_payload(payload, "p"))
    if len(new) != len(live):
        raise ValueError(
            f"checkpoint has {len(new)} parameter leaves but this "
            f"trainer expects {len(live)} — it was saved by a different "
            f"architecture or trainer layout")
    for i, (a, t) in enumerate(zip(new, live)):
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(
                f"checkpoint parameter leaf {i} has shape {a.shape} but "
                f"this trainer expects {tuple(t.shape)} — saved by a "
                f"different architecture or trainer layout")
    o = tree_from_payload(payload, "o", leaves_only=True)
    want = 1 + 2 * len(live) if isinstance(opt, torch.optim.Adam) else 0
    if len(o) != want:
        raise ValueError(
            f"checkpoint has {len(o)} optimizer leaves but this trainer's "
            f"optimizer expects {want} — optimizer config changed since "
            f"the save")
    with torch.no_grad():
        for a, t in zip(new, live):
            t.copy_(torch.as_tensor(a, dtype=t.dtype))
    if want:
        count = float(np.asarray(o[0]))
        n = len(live)
        for i, t in enumerate(live):
            opt.state[t] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": torch.as_tensor(o[1 + i], dtype=t.dtype).to(
                    t.device),
                "exp_avg_sq": torch.as_tensor(o[1 + n + i],
                                              dtype=t.dtype).to(t.device)}
