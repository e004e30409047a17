"""Transformer encoder (port of `mmlspark_tpu/models/dnn/transformer.py`).

A pre-norm encoder over hashed tokens whose attention runs dense
(`parallel/ring_attention.reference_attention`), through the flash
kernel (`ops/flash_attention.py`, the long-document path) or
sequence-parallel over a mesh (`ring_attention` with dense blocks,
`ulysses_attention`). Parameters are a plain dict of tensors with the
reference's tree layout, so the JAX package's weights convert leaf by
leaf (`params_from_numpy`). `TransformerSentenceEncoder` wraps it as a
pipeline stage: hash-tokenize -> embed -> encode -> mean-pool. The stage
saves and loads with its weights in the reference's state layout
(`leaf_{i}` in `jax.tree_util.tree_flatten` order), so a state saved by
either package loads into the other.
"""
from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

from ...core import Model, Param, Table
from ...core.params import HasInputCol, HasOutputCol, in_range, one_of
from ...device import resolve_device
from ...ops.flash_attention import flash_attention
from ...ops.hashing import hash_token
from ...parallel.mesh import DATA_AXIS, data_mesh
from ...parallel.ring_attention import (reference_attention, ring_attention,
                                        ulysses_attention)

_ATTENTION = ("dense", "flash", "ring", "ulysses")
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def init_transformer(vocab_size: int, d_model: int = 256, n_heads: int = 8,
                     n_layers: int = 4, d_ff: int = 1024,
                     max_len: int = 2048, seed: int = 0) -> dict:
    """Random-init encoder params (He-style scaling) as numpy arrays: a
    copy of the reference's, so the same seed gives the same weights bit
    for bit. `params_from_numpy` moves them to a device."""
    rng = np.random.default_rng(seed)

    def dense(fan_in, fan_out):
        return (rng.normal(scale=1.0 / np.sqrt(fan_in),
                           size=(fan_in, fan_out)).astype(np.float32))

    params = {
        "embed": rng.normal(scale=0.02, size=(vocab_size, d_model)
                            ).astype(np.float32),
        "pos": rng.normal(scale=0.02, size=(max_len, d_model)
                          ).astype(np.float32),
        "layers": [],
        "final_ln": {"scale": np.ones(d_model, np.float32),
                     "bias": np.zeros(d_model, np.float32)},
        "meta": {"n_heads": n_heads, "d_model": d_model},
    }
    for _ in range(n_layers):
        params["layers"].append({
            "ln1": {"scale": np.ones(d_model, np.float32),
                    "bias": np.zeros(d_model, np.float32)},
            "wq": dense(d_model, d_model), "wk": dense(d_model, d_model),
            "wv": dense(d_model, d_model), "wo": dense(d_model, d_model),
            "ln2": {"scale": np.ones(d_model, np.float32),
                    "bias": np.zeros(d_model, np.float32)},
            "w1": dense(d_model, d_ff), "b1": np.zeros(d_ff, np.float32),
            "w2": dense(d_ff, d_model), "b2": np.zeros(d_model, np.float32),
        })
    return params


def params_from_numpy(tree: dict, device=None) -> dict:
    """The JAX package's parameter tree -> the port's: every leaf (a numpy
    array, or anything `np.asarray` takes, such as a JAX array) becomes an
    f32 tensor on `device` (None = the card); `meta`, where the tree has
    one, stays Python ints. Takes the dict `init_transformer` returns in
    either package, and the LM trainers' trees: `layers` a list of
    per-layer dicts, or one dict of stacked (L, ...) leaves as
    `PipelinedLMTrainer` keeps them (no `meta`: the trainers hold it
    apart)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return torch.as_tensor(np.asarray(node, np.float32)).to(dev)

    out = {k: conv(v) for k, v in tree.items() if k != "meta"}
    if "meta" in tree:
        out["meta"] = {"n_heads": int(tree["meta"]["n_heads"]),
                       "d_model": int(tree["meta"]["d_model"])}
    return out


def params_to_numpy(tree: dict) -> dict:
    """The inverse of `params_from_numpy`: every tensor leaf becomes a
    numpy f32 array on the host, in the same dict/list layout; `meta`
    stays as it is."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        # a copy: on the CPU, .numpy() would share the tensor's memory
        return node.detach().float().cpu().numpy().copy()

    return {k: (dict(v) if k == "meta" else conv(v)) for k, v in tree.items()}


def _flatten(tree) -> list:
    """Leaves of a params tree (no `meta`) in `jax.tree_util.tree_flatten`
    order: dict keys sorted, lists in order, recursively."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _structure(tree):
    """The tree with every leaf replaced by None (its treedef)."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    return None


def _unflatten(structure, leaves: list):
    """The inverse of `_flatten` over `structure`; consumes `leaves`."""
    if isinstance(structure, dict):
        return {k: _unflatten(structure[k], leaves)
                for k in sorted(structure)}
    if isinstance(structure, list):
        return [_unflatten(v, leaves) for v in structure]
    return leaves.pop(0)


def _layer_norm(x, p):
    """Layer norm with f32 statistics whatever the activation dtype, eps
    1e-6, cast back to the activation dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) / torch.sqrt(var + 1e-6) * p["scale"] + p["bias"]
    return out.to(x.dtype)


def transformer_apply(params: dict, tokens, causal: bool = False,
                      attention: str = "dense", mesh=None, key_mask=None,
                      attention_dtype=None):
    """Encode (seq,) int tokens -> (seq, d_model) embeddings, or, with
    dense attention, a batch (B, seq) -> (B, seq, d_model).

    attention: 'dense', 'flash' (the flash kernel, no (S, S) score
    matrix), or 'ring' / 'ulysses' (sequence-parallel over `mesh`'s data
    axis, default `data_mesh()`; seq must divide by its size; the ring
    runs dense blocks, as the reference's does).
    key_mask: (seq,) or (B, seq) bool excluding padding keys (dense only).
    attention_dtype: cast q/k/v to this dtype (e.g. torch.bfloat16) after
    the f32 projections; scores and softmax stay f32 and the attention
    output is cast back to the residual dtype. The feed-forward uses the
    tanh-approximate GELU, as `jax.nn.gelu` does by default."""
    if attention not in _ATTENTION:
        raise ValueError(f"attention must be one of {_ATTENTION}, got "
                         f"{attention!r}")
    if key_mask is not None and attention != "dense":
        raise ValueError(
            f"key_mask is only supported with attention='dense'; "
            f"attention={attention!r} would silently ignore it — trim "
            f"padding instead")
    if isinstance(attention_dtype, str):
        attention_dtype = _DTYPES[attention_dtype]
    h = params["meta"]["n_heads"]
    d = params["meta"]["d_model"]
    dh = d // h
    tokens = torch.as_tensor(tokens, device=params["embed"].device)
    lead, seq = tuple(tokens.shape[:-1]), tokens.shape[-1]
    if seq > params["pos"].shape[0]:
        raise ValueError(
            f"sequence length {seq} exceeds the encoder's max_len "
            f"{params['pos'].shape[0]}; truncate or init with a larger "
            f"max_len")
    x = params["embed"][tokens.long()] + params["pos"][:seq]

    for lp in params["layers"]:
        y = _layer_norm(x, lp["ln1"])
        q = (y @ lp["wq"]).reshape(*lead, seq, h, dh)
        k = (y @ lp["wk"]).reshape(*lead, seq, h, dh)
        v = (y @ lp["wv"]).reshape(*lead, seq, h, dh)
        if attention_dtype is not None:
            q = q.to(attention_dtype)
            k = k.to(attention_dtype)
            v = v.to(attention_dtype)
        if attention == "ring":
            a = ring_attention(q, k, v, mesh=mesh, causal=causal)
        elif attention == "ulysses":
            a = ulysses_attention(q, k, v, mesh=mesh, causal=causal)
        elif attention == "flash":
            a = flash_attention(q, k, v, causal=causal)
        else:
            a = reference_attention(q, k, v, causal=causal,
                                    key_mask=key_mask)
        a = a.to(x.dtype)
        x = x + a.reshape(*lead, seq, d) @ lp["wo"]
        y = _layer_norm(x, lp["ln2"])
        x = x + F.gelu(y @ lp["w1"] + lp["b1"], approximate="tanh") \
            @ lp["w2"] + lp["b2"]
    return _layer_norm(x, params["final_ln"])


class TransformerSentenceEncoder(Model, HasInputCol, HasOutputCol):
    """Text -> fixed-size embeddings via hash tokenization + the encoder.
    The reference's Params, plus `device` (None = the card)."""
    vocab_bits = Param("vocab_bits", "hash-vocabulary bits", 14,
                       validator=in_range(4, 22))
    d_model = Param("d_model", "model width", 128)
    n_heads = Param("n_heads", "attention heads", 8)
    n_layers = Param("n_layers", "encoder blocks", 2)
    d_ff = Param("d_ff", "feed-forward width", 256)
    max_len = Param("max_len", "max tokens per document", 512)
    seed = Param("seed", "init seed", 0)
    attention = Param("attention",
                      "strategy for encode_long (single long documents): "
                      "dense | flash (the flash kernel, no (S,S) matrix) | "
                      "ring | ulysses (sequence-parallel over a mesh). "
                      "Batch transform() always runs dense.", "dense",
                      validator=one_of(*_ATTENTION))
    attention_dtype = Param(
        "attention_dtype",
        "cast q/k/v to this dtype inside encode_long's attention; "
        "softmax accumulation stays f32 on every path", None,
        validator=one_of(None, "bfloat16", "float32"))
    device = Param("device", "torch device to encode on (None = the card)",
                   None)

    def __init__(self, **kw):
        super().__init__(**kw)
        self._params = None
        self._loaded = None     # a loaded state's tree, moved on first use
        self._params_lock = threading.Lock()

    # -- weights ------------------------------------------------------------
    def _ensure_params(self) -> dict:
        """The weights on the stage's device, built or moved on first use.
        Serving scores one stage from several worker threads, so the first
        use is serialized: a second thread waits for the first one's
        tensors instead of building from the seed after the first has
        taken a loaded tree."""
        params = self._params
        if params is not None:
            return params
        with self._params_lock:
            if self._params is None:
                tree = self._loaded
                if tree is None:
                    tree = init_transformer(
                        1 << self.vocab_bits, self.d_model, self.n_heads,
                        self.n_layers, self.d_ff, self.max_len, self.seed)
                self._params = params_from_numpy(tree, self.device)
                self._loaded = None
            return self._params

    def _architecture(self):
        """(params structure without `meta`, `meta`) that this stage's
        architecture Params give. The structure depends on n_layers alone,
        so it is read off a one-wide tree."""
        tree = init_transformer(1, 1, 1, self.n_layers, 1, 1)
        meta = {"n_heads": self.n_heads, "d_model": self.d_model}
        return _structure({k: v for k, v in tree.items() if k != "meta"}), \
            meta

    def _get_state(self):
        p = self._ensure_params()
        structure, _ = self._architecture()
        no_meta = {k: v for k, v in p.items() if k != "meta"}
        if _structure(no_meta) != structure:
            # load rebuilds the tree from the Params: a custom tree from
            # set_params_tree would bind its leaves wrongly, so refuse here
            raise ValueError(
                "params tree structure does not match this stage's "
                "architecture Params (custom set_params_tree layout?); "
                "align the Params with the tree before saving")
        return {f"leaf_{i}": v.detach()
                for i, v in enumerate(_flatten(no_meta))}

    def _set_state(self, s):
        """Take a state of either package (numpy arrays or tensors, the
        reference's `leaf_{i}` layout); the weights move to `device` when
        the stage is first used."""
        structure, meta = self._architecture()
        leaves = [s[f"leaf_{i}"] for i in range(len(s))]
        if len(leaves) != len(_flatten(structure)):
            raise ValueError(
                f"state holds {len(leaves)} leaves; this stage's "
                f"architecture Params need {len(_flatten(structure))}")
        tree = _unflatten(structure, leaves)
        tree["meta"] = meta
        self._loaded = tree
        self._params = None

    def set_params_tree(self, params: dict) -> "TransformerSentenceEncoder":
        """Use `params`, a tree in the reference's layout (numpy or JAX
        leaves; see `params_from_numpy`)."""
        self._params = params_from_numpy(params, self.device)
        self._loaded = None
        return self

    # -- tokenization -------------------------------------------------------
    def _tokenize(self, text: str) -> np.ndarray:
        mask = (1 << self.vocab_bits) - 1
        toks = [hash_token(w) & mask for w in str(text).lower().split()]
        return np.asarray(toks[: self.max_len], np.int32)

    def _transform(self, t: Table) -> Table:
        """Batched dense encode, mean-pooled over each document's real
        tokens. Width is padded to a power of two capped at max_len;
        padding keys are masked out of attention, so a document's
        embedding does not depend on the rest of the batch."""
        rows = [self._tokenize(v) for v in t[self.input_col]]
        longest = max((len(r) for r in rows), default=1) or 1
        width = 1
        while width < longest:
            width *= 2
        width = min(width, self.max_len)
        batch_tok = np.zeros((len(t), width), np.int32)
        lengths = np.zeros(len(t), np.int32)
        for i, r in enumerate(rows):
            batch_tok[i, :len(r)] = r
            lengths[i] = len(r)
        params = self._ensure_params()
        dev = params["embed"].device
        length = torch.as_tensor(lengths, device=dev)
        real = torch.arange(width, device=dev)[None, :] < length[:, None]
        with torch.inference_mode():
            emb = transformer_apply(params, torch.as_tensor(batch_tok,
                                                            device=dev),
                                    attention="dense", key_mask=real)
            pooled = (emb * real[..., None]).sum(1) \
                / length.clamp_min(1)[:, None]
        return t.with_column(self.output_col,
                             pooled.float().cpu().numpy())

    def encode_long(self, tokens, mesh=None) -> np.ndarray:
        """Encode ONE long document, (seq,) token ids -> (seq, d_model),
        with the configured attention; 'ring'/'ulysses' run
        sequence-parallel over `mesh` (default `data_mesh()`)."""
        if self.attention in ("ring", "ulysses"):
            mesh = mesh or data_mesh()
            n_dev = mesh.shape[DATA_AXIS]
            if len(tokens) % n_dev:
                raise ValueError(
                    f"attention={self.attention!r} shards the sequence over "
                    f"{n_dev} devices; length {len(tokens)} is not "
                    f"divisible — pad/truncate the document or use "
                    f"attention='dense'")
        params = self._ensure_params()
        tok = torch.as_tensor(np.asarray(tokens, np.int64),
                              device=params["embed"].device)
        with torch.inference_mode():
            out = transformer_apply(params, tok, attention=self.attention,
                                    mesh=mesh,
                                    attention_dtype=self.attention_dtype)
        return out.cpu().numpy()
