"""Causal LM training with dense attention over a data x model mesh
(port of `mmlspark_tpu/models/dnn/lm_training.py`'s `_lm_loss` and
`ShardedLMTrainer`).

The reference lays the parameters over a dp x tp mesh in the Megatron
layout (`_param_shardings`: wq/wk/wv/w1/b1 cut on their outputs, wo/w2
on their inputs, the rest replicated) and lets XLA insert the
collectives. The port holds the same blocks once each, per model
position, and drives every position from one process with the Megatron
f/g operators and blocks of `pp_training` (one copy of that code): batch
rows shard over the data axis, attention is dense (the reference keeps
dense attention under GSPMD), and the loss is the mean next-token
cross-entropy over the whole batch. With mesh=None it trains on one
device; it is the reference's own oracle for `PipelinedLMTrainer`.

Step checkpoints of both LM trainers live here, as in the reference:
`save_lm_checkpoint` / `restore_lm_checkpoint` over `utils.checkpoint`'s
`CheckpointManager`, in the reference's payload (its `meta`, the params
by `payload.tree_to_payload`, and the optimizer's leaves in
`optax.adam`'s flatten order, count, mu..., nu..., which map to and from
`torch.optim.Adam`'s `step`, `exp_avg` and `exp_avg_sq`), so a checkpoint
written by either package, on any mesh, restores in the other. A trainer
that holds its parameters in blocks over a mesh (`pp_training._Blocks`)
gathers every leaf and its Adam state to the full leaf on save and cuts
them back into its blocks on restore.

`ShardedLMTrainer.run_stream` trains over a stream of host batches, each
copied to the card by `data.DevicePrefetcher` while the one before trains;
with `checkpoint_dir` it runs under `reliability.TrainingSupervisor`
(restart, resume and preemption), its snapshots in the same payload.

Over a mesh that spans processes `ShardedLMTrainer` trains as
`PipelinedLMTrainer` does (`pp_training`'s module docstring): each
process holds its positions' masters, Megatron's f and g cross processes
as messages, replicated masters' gradients and the loss are summed in
rank order. A checkpoint is gathered to every process and written by the
first one, then every process meets at a barrier (the reference's
`save_lm_checkpoint`); a restore reads the file on every process, each
taking its own blocks. A supervised `run_stream` over processes is
refused, as in the reference.
"""
from __future__ import annotations

import functools
import operator

import numpy as np
import torch

from ...device import resolve_device
from ...parallel import cluster
from ...parallel.mesh import DATA_AXIS, MODEL_AXIS
from ...utils.checkpoint import CheckpointManager
from .payload import tree_from_payload, tree_to_payload
from .pp_training import (_Blocks, _Span, _Where, _block, _check_device,
                          _copies_per_step, _gather, _local_or_none,
                          _megatron_index, _mesh_sizes, _nest, _update)
from .transformer import _flatten, _layer_norm, init_transformer

class ShardedLMTrainer:
    """Causal LM trainer with dense attention and Adam: loss =
    t.step(tokens), (B, S) int tokens, B % dp == 0. The reference's
    parameters, plus `device` (None = the card). With mesh=None it trains
    on `device`; a mesh (`parallel.grid_mesh((dp, tp))`) must have the
    "data" and "model" axes: batch rows shard over data, the heads and
    d_ff over model. The embedding, positions, layer norms and b2 live on
    the mesh's first device; `device`, if given, must be that device."""

    def __init__(self, vocab_size: int, mesh=None, d_model: int = 128,
                 n_heads: int = 8, n_layers: int = 2, d_ff: int = 256,
                 max_len: int = 512, lr: float = 1e-3, seed: int = 0,
                 device=None):
        if d_model % n_heads:
            raise ValueError(
                f"d_model ({d_model}) must divide by n_heads ({n_heads})")
        self._span = None
        if mesh is None:
            self.device = resolve_device(device)
            self.dp = self.tp = 1
            self._devs = self._owners = [[self.device]]
        else:
            for axis in (DATA_AXIS, MODEL_AXIS):
                if axis not in mesh.shape:
                    raise ValueError(f"ShardedLMTrainer's mesh needs the "
                                     f"{DATA_AXIS!r} and {MODEL_AXIS!r} "
                                     f"axes; got axes {mesh.axis_names}")
            _, self.tp, _ = _mesh_sizes(mesh, n_heads, d_ff)
            self.dp = mesh.shape[DATA_AXIS]
            self.device = mesh.devices.flat[0]
            _check_device(device, self.device)
            grid = [[dict(data=d, model=j) for j in range(self.tp)]
                    for d in range(self.dp)]
            # _devs[d][j]: the device of (data d, model j), None where
            # another process's; _owners[d][j] its process
            self._devs = _nest(lambda p: _local_or_none(mesh, **p), grid)
            self._owners = _nest(lambda p: mesh.process_of(**p), grid)
            if mesh.process_count > 1:
                self._span = _Span(mesh, {
                    "shared": [dict(data=d) for d in range(self.dp)],
                    **{j: [dict(data=d, model=j) for d in range(self.dp)]
                       for j in range(self.tp)}})
        self.mesh = mesh
        self._n_layers = n_layers
        raw = init_transformer(vocab_size, d_model, n_heads, n_layers, d_ff,
                               max_len, seed)
        self.meta = raw.pop("meta")

        def home_of(key):
            # a key's masters live on the device of the first of its
            # positions this process owns
            j = 0 if key == "shared" else key
            return next((row[j] for row in self._devs
                         if row[j] is not None), None)

        def placement(path, shape):
            if path[0] != "layers":
                yield "shared", home_of("shared"), ()
                return
            for j in range(self.tp):
                index = _megatron_index(path[2], shape, j, self.tp)
                if index is not None:
                    yield j, home_of(j), index
        self._blocks = _Blocks(raw, placement, self._span)
        self._opt = torch.optim.Adam(self._blocks.masters(), lr=lr,
                                     betas=(0.9, 0.999), eps=1e-8)

    @property
    def params(self) -> dict:
        """The parameters in the reference's layout (a list of per-layer
        dicts): a leaf held whole is its master, a cut one a detached
        tensor on the first device assembled from its blocks. Over
        processes a collective (every process must read it)."""
        return self._blocks.tree(self.device)

    def position_params(self, model: int = 0) -> list:
        """The per-layer masters that model position `model` holds, e.g.
        wq of shape (d, d / model); ln1, ln2 and b2 at model 0. Over
        processes a collective."""
        layers = self._blocks.key_tree(model, self.device)["layers"]
        return [layers[i] for i in sorted(layers)]

    def _tags(self, tokens) -> cluster.MessageTags:
        """The message tags of one step over processes."""
        return cluster.MessageTags(kind=6, data=self.dp,
                                   layer=self._n_layers,
                                   model=self.tp)

    def _loss(self, tokens, link=None):
        """The reference's `_lm_loss`, the mean next-token cross-entropy
        of the causal dense forward over the whole batch: per data shard
        the sum of its NLL, then the sum over shards; returns (that sum,
        its divisors). Over processes (`link`) this process's shards
        only."""
        on = _copies_per_step(self._blocks.trees, torch.float32)
        n_heads, d = self.meta["n_heads"], self.meta["d_model"]
        dh, h_loc = d // n_heads, n_heads // self.tp
        b, seq = tokens.shape
        b_loc = b // self.dp
        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for di, devs in enumerate(self._devs):
            if all(dev is None for dev in devs):
                continue
            pc = None if devs[0] is None else on("shared", devs[0])
            layers = [None if dev is None else on(j, dev)["layers"]
                      for j, dev in enumerate(devs)]
            x = rows = None
            if pc is not None:
                rows = tokens[di * b_loc:(di + 1) * b_loc].to(devs[0])
                x = pc["embed"][rows] + pc["pos"][:seq]
            for i in range(self._n_layers):
                where = None if link is None else _Where(
                    [list(devs)], [list(self._owners[di])], self._span.rank,
                    link, functools.partial(link.tags, data=di, layer=i),
                    ((b_loc, seq, d), torch.float32))
                x, = _block([x], [[None if lp is None else lp[i]
                                   for lp in layers]], h_loc, dh,
                            where=where)
            if x is None:
                continue
            logits = _layer_norm(x, pc["final_ln"]) @ pc["embed"].T
            logp = torch.log_softmax(logits[:, :-1], dim=-1)
            nll = -logp.gather(-1, rows[:, 1:, None])[..., 0]
            total = total + nll.sum().to(self.device)
        return total, (b * (seq - 1), 1)

    def _update(self, tokens):
        return _update(self, tokens)

    def _check_batch(self, tokens) -> None:
        if tokens.shape[0] % self.dp:
            raise ValueError(f"batch {tokens.shape[0]} must divide by the "
                             f"data axis ({self.dp})")

    def _to_device(self, tokens):
        return torch.as_tensor(np.asarray(tokens), device=self.device).long()

    def step(self, tokens: np.ndarray) -> float:
        """One Adam update; returns the batch loss (before the update)."""
        self._check_batch(tokens)
        return float(self._update(self._to_device(tokens)))

    def run(self, tokens: np.ndarray, n_steps: int) -> float:
        """n_steps chained updates on the same batch with ONE host sync, at
        the end; returns the last step's loss."""
        self._check_batch(tokens)
        n_steps = operator.index(n_steps)
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        tok = self._to_device(tokens)
        for _ in range(n_steps):
            loss = self._update(tok)
        return float(loss)

    def run_stream(self, batches, steps_per_batch: int = 1,
                   prefetch: int = 2, checkpoint_dir: str = None,
                   checkpoint_every: int = 10, resume: bool = True,
                   step_clock=None, **supervisor_kw) -> list:
        """Train over an iterable of host (B, S) token batches with the
        bounded prefetcher (`data.DevicePrefetcher`): batch k+1 is copied
        to the trainer's device (and any upstream loading the iterable
        does runs) WHILE batch k trains. Returns the per-batch final
        losses; `steps_per_batch > 1` chains that many updates on each
        batch, as `run` does, with one host sync.

        `checkpoint_dir` turns on supervision
        (`reliability.TrainingSupervisor`): the state is snapshotted every
        `checkpoint_every` batches in `lm_state_payload`'s format and
        written in the background, SIGTERM/SIGINT write a final
        synchronous checkpoint and raise `reliability.Preempted`, failed
        steps restart from the last snapshot, and a run started again
        with `resume=True` continues from the newest digest-valid
        checkpoint, bit for bit as the uninterrupted run (the batch
        cursor and loss history ride in the payload). `batches` must then
        be a finite re-indexable sequence. Extra keywords (step_timeout,
        retry_policy, faults, ...) pass to TrainingSupervisor; without
        `checkpoint_dir` they raise TypeError.

        `step_clock` (`telemetry.goodput.StepClock`, created when
        supervised) books the prefetcher's data-wait, the loss fetch as
        device time, and every step's goodput account."""
        from ...data import DevicePrefetcher
        steps_per_batch = operator.index(steps_per_batch)
        if steps_per_batch < 1:
            raise ValueError(
                f"steps_per_batch must be >= 1, got {steps_per_batch}")
        clock = step_clock

        def one_batch(tok_dev):
            self._check_batch(tok_dev)
            tok = tok_dev.long()
            for _ in range(steps_per_batch):
                loss = self._update(tok)
            # float(loss) is the step's sync with the card
            if clock is not None:
                return clock.device_block(lambda: float(loss))
            return float(loss)

        def prefetcher(source):
            return DevicePrefetcher(source, depth=prefetch,
                                    device=self.device, step_clock=clock)

        if checkpoint_dir is None:
            if supervisor_kw:
                raise TypeError(
                    f"supervisor options {sorted(supervisor_kw)} require "
                    f"checkpoint_dir")
            with prefetcher(batches) as pf:
                return [one_batch(tok_dev) for tok_dev in pf]

        if self._span is not None:
            # every process would race the same step directory (the
            # supervisor's background writer has no rendezvous), as the
            # reference refuses
            raise NotImplementedError(
                "run_stream(checkpoint_dir=...) is single-process for now; "
                "multi-process jobs should checkpoint via save_checkpoint "
                "(leader-only write + barrier)")
        from ...reliability.supervisor import TrainingSupervisor
        from ...telemetry.goodput import StepClock
        if clock is None:
            clock = StepClock()
        batches = list(batches)   # rewind/resume needs random access

        def snapshot():
            return lm_state_payload(self.params, self._opt, self.meta,
                                    self._blocks)

        def restore(payload):
            lm_state_from_payload(payload, self.params, self._opt,
                                  self.meta, self._blocks)

        stream = {"pf": None, "it": None}

        def seek(step):
            if stream["pf"] is not None:
                stream["pf"].close()
            pf = prefetcher(batches[step:])
            stream["pf"], stream["it"] = pf, iter(pf)

        def step_fn(step):
            return one_batch(next(stream["it"]))

        sup = TrainingSupervisor(checkpoint_dir, snapshot, restore,
                                 checkpoint_every=checkpoint_every,
                                 step_clock=clock, **supervisor_kw)
        try:
            return sup.run(step_fn, len(batches), seek=seek, resume=resume)
        finally:
            if stream["pf"] is not None:
                stream["pf"].close()
            sup.close()

    def save_checkpoint(self, directory: str, step: int) -> None:
        """Params and optimizer state, gathered into the reference's
        leaves, as checkpoint `step` of `directory` (over processes a
        collective: the first process writes, then a barrier)."""
        save_lm_checkpoint(directory, step, self.params, self._opt,
                           self.meta, self._blocks)

    def restore_checkpoint(self, directory: str, step: int = None) -> int:
        """Load params and optimizer state from the latest (or the given)
        step into this trainer's blocks, in place; returns the step
        loaded. Over processes every process reads the file and takes its
        own blocks (a collective)."""
        return restore_lm_checkpoint(directory, step, self.params,
                                     self._opt, self.meta, self._blocks)


def _pieces(params, blocks) -> list:
    """Each leaf's (master, index) pieces in flatten order: the blocks',
    or, without blocks, every leaf of `params` its own master, whole."""
    if blocks is not None:
        return blocks.pieces
    return [[(t, ())] for t in _flatten(params)]


def _adam_leaves(params, opt, blocks=None) -> list:
    """The optimizer's state as `optax.adam`'s flattened state: [count,
    mu leaves..., nu leaves...] in the params' flatten order (zeros before
    the first step), each leaf gathered from its pieces (`_pieces`; over
    processes `_Blocks.leaves`, a collective); [] for SGD, which keeps
    none."""
    if not isinstance(opt, torch.optim.Adam):
        return []
    pieces, like = _pieces(params, blocks), _flatten(params)
    masters = [m for p in pieces for m, _ in p]
    first = opt.state.get(masters[0], {}) if masters else {}
    count = int(first["step"]) if first else 0

    def state(key):
        return lambda m: (opt.state[m][key] if m in opt.state
                          else torch.zeros_like(m))
    if blocks is not None and blocks.span is not None:
        dev = like[0].device
        mu = blocks.leaves(dev, state("exp_avg"))
        nu = blocks.leaves(dev, state("exp_avg_sq"))
    else:
        mu = [_gather(p, t.shape, t.device, state("exp_avg"))
              for p, t in zip(pieces, like)]
        nu = [_gather(p, t.shape, t.device, state("exp_avg_sq"))
              for p, t in zip(pieces, like)]
    return [np.asarray(count, np.int32)] + mu + nu


def lm_state_payload(params, opt, meta, blocks=None) -> dict:
    """A trainer's live state as a checkpoint payload, the reference's
    layout: `meta`, the params with their treedef (prefix "p"), and the
    optimizer's leaves alone (prefix "o"). `params` is the reference's
    tree; `blocks`, where the trainer holds it in blocks, says where each
    leaf's optimizer state lives."""
    payload = {"meta": dict(meta)}
    payload.update(tree_to_payload(params, "p"))
    payload.update(tree_to_payload(_adam_leaves(params, opt, blocks), "o",
                                   leaves_only=True))
    return payload


def save_lm_checkpoint(directory: str, step: int, params, opt, meta,
                       blocks=None) -> None:
    """Write the trainer's state as step `step` (shared by both
    trainers: one implementation, one on-disk format). Over processes
    (`blocks.span`) every process gathers the payload, the first one
    writes it and all meet at a barrier, as the reference's leader-only
    write."""
    payload = lm_state_payload(params, opt, meta, blocks)
    if blocks is None or blocks.span is None:
        CheckpointManager(directory).save(step, payload)
        return
    if blocks.span.rank == 0:
        CheckpointManager(directory).save(step, payload)
    cluster.barrier(f"lm_ckpt_{step}")


def restore_lm_checkpoint(directory: str, step, params, opt, meta,
                          blocks=None) -> int:
    """Load step `step` (None: the newest readable one, past a torn or
    corrupt newest step) into the live params and optimizer; returns the
    step loaded."""
    mgr = CheckpointManager(directory)
    if step is None:
        payload, step = mgr.restore(with_step=True)
    else:
        payload = mgr.restore(step)
    lm_state_from_payload(payload, params, opt, meta, blocks)
    return step


def lm_state_from_payload(payload, params, opt, meta, blocks=None) -> None:
    """Apply a checkpoint payload to the live state in place: every param
    leaf copied into its masters (cut into the blocks' pieces; the
    optimizer keeps its references), the optimizer's state rebuilt from
    `optax.adam`'s leaves the same way. Refuses another model config
    ("different model") and another layout ("parameter leaves", shapes),
    as the reference does."""
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

    def block(a, m, index):
        # always a copy: on the CPU `as_tensor` shares the payload's
        # memory, and the optimizer's moments are updated in place (a
        # payload restored twice, as the supervisor's in-memory snapshot
        # is, must not change in between)
        return torch.as_tensor(np.ascontiguousarray(np.asarray(a)[index]),
                               dtype=m.dtype).to(m.device, copy=True)
    pieces = _pieces(params, blocks)
    with torch.no_grad():
        for a, leaf in zip(new, pieces):
            for m, index in leaf:
                m.copy_(block(a, m, index))
    if want:
        count = float(np.asarray(o[0]))
        n = len(live)
        for i, leaf in enumerate(pieces):
            for m, index in leaf:
                opt.state[m] = {
                    "step": torch.tensor(count, dtype=torch.float32),
                    "exp_avg": block(o[1 + i], m, index),
                    "exp_avg_sq": block(o[1 + n + i], m, index)}
