"""Parameter trees as checkpoint payloads, in the reference's portable
layout (`mmlspark_tpu/models/dnn/model.py`'s `tree_to_payload`,
`tree_from_payload` and `_treedef_to_str`): `{prefix}_{i}` numpy leaves
in `jax.tree_util.tree_flatten` order (dict keys sorted, lists in order),
their count `n_{prefix}`, and, unless `leaves_only`, the tree's JSON
description `treedef_{prefix}` (`{"d": {...}}` for a dict, `{"l": [...]}`
for a list, "leaf"). A payload written by either package reads in the
other. The leaf order is the encoder state's (`transformer._flatten`).
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .transformer import _flatten


def _treedef_to_str(tree) -> str:
    """The portable description of a tree of dicts and lists."""
    def describe(t):
        if isinstance(t, dict):
            return {"d": {k: describe(v) for k, v in sorted(t.items())}}
        if isinstance(t, (list, tuple)):
            return {"l": [describe(v) for v in t]}
        return "leaf"
    return json.dumps(describe(tree))


def _treedef_from_str(s: str, leaves: list):
    """The tree `s` describes, its leaves taken from `leaves` in order."""
    it = iter(leaves)

    def build(d):
        if d == "leaf":
            return next(it)
        if "d" in d:
            return {k: build(v) for k, v in d["d"].items()}
        return [build(v) for v in d["l"]]
    return build(json.loads(s))


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.asarray(leaf)


def tree_to_payload(tree, prefix: str, leaves_only: bool = False) -> dict:
    """`tree` (tensors or arrays; or, with `leaves_only`, a flat list in
    flatten order) as payload keys."""
    leaves = list(tree) if leaves_only else _flatten(tree)
    out = {f"n_{prefix}": len(leaves)}
    if not leaves_only:
        out[f"treedef_{prefix}"] = _treedef_to_str(tree)
    for i, leaf in enumerate(leaves):
        out[f"{prefix}_{i}"] = _host(leaf)
    return out


def tree_from_payload(payload: dict, prefix: str, leaves_only: bool = False):
    """The inverse of `tree_to_payload`: the tree of numpy leaves, or
    (`leaves_only`) the flat leaf list."""
    n = int(np.asarray(payload[f"n_{prefix}"]))
    leaves = [np.asarray(payload[f"{prefix}_{i}"]) for i in range(n)]
    if leaves_only:
        return leaves
    return _treedef_from_str(str(payload[f"treedef_{prefix}"]), leaves)
