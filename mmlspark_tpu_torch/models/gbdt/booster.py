"""Booster: the serializable trained GBDT ensemble.

Port of `mmlspark_tpu/models/gbdt/booster.py`. The tree arrays are host
numpy, stacked (n_trees, max_nodes), and the JSON model string is the
reference's format, categorical splits included, so either package loads
the other's.

Scoring has two paths, as in the reference: serving-sized batches descend
on the host in numpy (no device round trip per request), bulk batches
descend on the device (`trainer.predict_raw`). Both take the same
decisions: go right unless x <= threshold, NaN right; a categorical node
goes left iff the raw id's identity bin is in its packed set.
"""
from __future__ import annotations

import json
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...device import resolve_device
from . import trainer

# raw_score batches under this row count (and work bound, rows x trees x
# depth) score on the HOST: a serving microbatch must not pay a device
# round trip per batch
_HOST_PREDICT_MAX_ROWS = 4096
_HOST_PREDICT_MAX_WORK = 20_000_000


class Booster(NamedTuple):
    split_feature: np.ndarray   # (T, max_nodes) i32, -1 = leaf
    threshold: np.ndarray       # (T, max_nodes) f32 real-valued bounds
    split_bin: np.ndarray       # (T, max_nodes) i32 (train-time thresholds)
    leaf_value: np.ndarray      # (T, max_nodes) f32
    tree_class: np.ndarray      # (T,) i32 class id (0 for single-output)
    max_depth: int
    n_classes: int              # output width (1 for binary/regression margin)
    objective: str
    n_features: int
    best_iteration: int = -1    # early stopping; -1 = use all trees
    gain: Optional[np.ndarray] = None    # (T, max_nodes) f32 split gains
    cover: Optional[np.ndarray] = None   # (T, max_nodes) f32 node row counts
    # native categorical splits: flagged nodes route by membership of the
    # raw category id in the node's packed 16-bit words; None = no
    # categorical split
    split_is_cat: Optional[np.ndarray] = None  # (T, max_nodes) bool
    cat_words: Optional[np.ndarray] = None     # (T, max_nodes, W16) i32

    @property
    def n_trees(self) -> int:
        return self.split_feature.shape[0]

    def _cat_args(self, s):
        """(split_is_cat, cat_words) slices for scoring, or (None, None)
        for a purely numeric ensemble."""
        if self.split_is_cat is None or self.cat_words is None:
            return None, None
        return self.split_is_cat[s], self.cat_words[s]

    def _used_trees(self):
        if self.best_iteration >= 0:
            per_iter = max(self.n_classes, 1)
            return slice(0, (self.best_iteration + 1) * per_iter)
        return slice(None)

    # -- scoring -----------------------------------------------------------
    def raw_score(self, x, init_score: float = 0.0, backend: str = "auto",
                  device=None):
        """(n, F) f32 -> (n, n_classes) raw margins as numpy.

        backend: "auto" scores small batches on the host and bulk batches
        on `device` (None = the card); "host"/"device" force a path."""
        if backend not in ("auto", "host", "device"):
            raise ValueError(
                f"backend must be auto|host|device, got {backend!r}")
        s = self._used_trees()
        ic, cw = self._cat_args(s)
        n_used = len(range(*s.indices(self.n_trees)))
        n_rows = x.shape[0]
        work = n_rows * n_used * max(self.max_depth, 1)
        if backend == "host" or (backend == "auto"
                                 and n_rows < _HOST_PREDICT_MAX_ROWS
                                 and work <= _HOST_PREDICT_MAX_WORK):
            out = _predict_raw_host(
                np.asarray(x, dtype=np.float32), self.split_feature[s],
                self.threshold[s], self.leaf_value[s], self.tree_class[s],
                self.max_depth, self.n_classes, split_is_cat=ic,
                cat_words=cw)
        else:
            out = self.raw_score_device(x, device=device, trees=s)
            out = out.cpu().numpy()
        return out + init_score

    def raw_score_device(self, x, device=None, trees=None) -> torch.Tensor:
        """Device scoring: (n, F) rows (numpy or tensor) -> (n, n_classes)
        f32 margins as a tensor on `device` (None = the card)."""
        dev = resolve_device(device)
        s = self._used_trees() if trees is None else trees
        xd = torch.as_tensor(x, dtype=torch.float32).to(dev)

        def put(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(dev)
        ic, cw = self._cat_args(s)
        return trainer.predict_raw(
            xd, put(self.split_feature[s], torch.int32),
            put(self.threshold[s], torch.float32),
            put(self.leaf_value[s], torch.float32),
            np.asarray(self.tree_class[s]), self.max_depth, self.n_classes,
            split_is_cat=None if ic is None else put(ic, torch.bool),
            cat_words=None if cw is None else put(cw, torch.int32))

    def scoring_plan(self, init_score: float = 0.0):
        """Prebuilt host scoring closure for the serving path: the
        used-tree slice and init score resolve once, and the descent is
        TREE-PARALLEL — all trees step down one level per numpy op over an
        (n, T) node matrix. Margins match `raw_score` to f32 summation
        tolerance (trees sum pairwise here, in order there)."""
        s = self._used_trees()
        sf = np.ascontiguousarray(self.split_feature[s], np.int64)
        thr = np.ascontiguousarray(self.threshold[s], np.float32)
        lv = np.ascontiguousarray(self.leaf_value[s], np.float32)
        tc = np.ascontiguousarray(self.tree_class[s], np.int64)
        ic, cw = self._cat_args(s)
        depth, k = self.max_depth, self.n_classes
        n_trees, m = sf.shape
        offs = np.arange(n_trees, dtype=np.int64) * m     # flat tree bases
        sf_f, thr_f, lv_f = sf.ravel(), thr.ravel(), lv.ravel()
        has_cat = ic is not None and cw is not None and cw.shape[-1] > 0
        if has_cat:
            ic_f = np.ascontiguousarray(ic, bool).ravel()
            w16 = cw.shape[-1]
            cw_f = np.ascontiguousarray(cw, np.int64).ravel()
        class_mask = None
        if k > 1:
            class_mask = (tc[None, :] == np.arange(k)[:, None]).astype(
                np.float32)                                # (k, T)
        n_features = self.n_features

        def plan(x: np.ndarray) -> np.ndarray:
            x = np.asarray(x, dtype=np.float32)
            # the descent CLIPS feature indices, so a wrong-width row would
            # silently score against the wrong features — reject it here
            if x.ndim != 2 or x.shape[1] != n_features:
                raise ValueError(
                    f"expected (n, {n_features}) features, got {x.shape}")
            n, n_feat = x.shape
            rows = np.arange(n)[:, None]
            node = np.zeros((n, n_trees), np.int64)
            for _ in range(depth):
                idx = node + offs
                f = sf_f[idx]                              # (n, T)
                xf = x[rows, np.clip(f, 0, n_feat - 1)]
                with np.errstate(invalid="ignore"):
                    go_left = xf <= thr_f[idx]
                if has_cat:
                    b = _raw_to_cat_bin_np(xf, w16)
                    member = ((cw_f[idx * w16 + (b >> 4)] >> (b & 15))
                              & 1) == 1
                    go_left = np.where(ic_f[idx], member, go_left)
                child = np.where(go_left, 2 * node + 1, 2 * node + 2)
                node = np.where(f < 0, node, child)
            leaf = lv_f[node + offs]                       # (n, T)
            if class_mask is None:
                return leaf.sum(axis=1, keepdims=True) + init_score
            return leaf @ class_mask.T + init_score
        return plan

    # -- persistence (the reference's JSON format) ----------------------------
    def to_dict(self) -> dict:
        out = {
            "meta": json.dumps({
                "max_depth": self.max_depth, "n_classes": self.n_classes,
                "objective": self.objective, "n_features": self.n_features,
                "best_iteration": self.best_iteration}),
            "split_feature": self.split_feature,
            "threshold": self.threshold,
            "split_bin": self.split_bin,
            "leaf_value": self.leaf_value,
            "tree_class": self.tree_class,
        }
        if self.gain is not None:
            out["gain"] = self.gain
        if self.cover is not None:
            out["cover"] = self.cover
        if self.split_is_cat is not None:
            out["split_is_cat"] = self.split_is_cat
            out["cat_words"] = self.cat_words
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "Booster":
        meta = json.loads(str(d["meta"]))
        f32, i32 = np.float32, np.int32
        return cls(split_feature=np.asarray(d["split_feature"], i32),
                   threshold=np.asarray(d["threshold"], f32),
                   split_bin=np.asarray(d["split_bin"], i32),
                   leaf_value=np.asarray(d["leaf_value"], f32),
                   tree_class=np.asarray(d["tree_class"], i32),
                   gain=(np.asarray(d["gain"], f32) if "gain" in d else None),
                   cover=(np.asarray(d["cover"], f32) if "cover" in d
                          else None),
                   split_is_cat=(np.asarray(d["split_is_cat"], bool)
                                 if "split_is_cat" in d else None),
                   cat_words=(np.asarray(d["cat_words"], i32)
                              if "cat_words" in d else None),
                   **meta)

    def save_model_string(self) -> str:
        d = self.to_dict()
        return json.dumps({k: (v if isinstance(v, str)
                               else np.asarray(v).tolist())
                           for k, v in d.items()})

    @classmethod
    def load_model_string(cls, s: str) -> "Booster":
        return cls.from_dict(json.loads(s))


def _raw_to_cat_bin_np(xf: np.ndarray, w16: int) -> np.ndarray:
    """`trainer.raw_to_cat_bin` in numpy, any shape: the one host copy of
    the identity-bin mapping every host scoring path shares."""
    top = w16 * 16 - 1
    with np.errstate(invalid="ignore"):
        b = np.clip(np.ceil(xf - 0.5), 0, top)
    return np.where(np.isnan(xf), top, b).astype(np.int64)


def _cat_member_np(xf, words_rows):
    """Membership of raw values xf (n,) in (n, W16) packed words: the
    numpy oracle of `trainer.raw_to_cat_bin` + `trainer.packed_member`."""
    w16 = words_rows.shape[-1]
    if w16 == 0:
        return np.zeros(xf.shape, bool)
    b = _raw_to_cat_bin_np(xf, w16)
    word = words_rows[np.arange(xf.shape[0]), b >> 4]
    return ((word >> (b & 15)) & 1) == 1


def _predict_raw_host(x, split_feature, threshold, leaf_value, tree_class,
                      max_depth: int, n_classes: int, split_is_cat=None,
                      cat_words=None):
    """Vectorized numpy ensemble descent — the host mirror of
    `trainer.predict_raw`, with the same decisions and the same
    tree-order f32 sums."""
    n = x.shape[0]
    rows = np.arange(n)
    scores = np.zeros((n, n_classes), np.float32)
    has_cat = (split_is_cat is not None and cat_words is not None
               and cat_words.shape[-1] > 0)
    for t in range(split_feature.shape[0]):
        sf_t, thr_t, lv_t = split_feature[t], threshold[t], leaf_value[t]
        node = np.zeros(n, np.int32)
        for _ in range(max_depth):
            f = sf_t[node]
            xf = x[rows, np.clip(f, 0, x.shape[1] - 1)]
            with np.errstate(invalid="ignore"):
                go_left = xf <= thr_t[node]
            if has_cat:
                member = _cat_member_np(xf, cat_words[t][node])
                go_left = np.where(split_is_cat[t][node], member, go_left)
            child = np.where(go_left, 2 * node + 1, 2 * node + 2)
            node = np.where(f < 0, node, child).astype(np.int32)
        scores[rows, tree_class[t]] += lv_t[node]
    return scores
