"""KNN / ConditionalKNN: exact top-k maximum-inner-product search on the
card.

Port of the reference's `nn/knn.py` (role: the reference's ball-tree
stack, nn/BallTree.scala:30-271, nn/KNN.scala:19-126,
nn/ConditionalKNN.scala:20-121): exact brute-force scoring `Q @ Xᵀ` on
the model's device (None = the card), f32 under `device.exact_f32` (a
TF32 product reorders neighbours), followed by the reference's top-k
(`ops.topk.top_k`: the lower index first among equal products), in tiles
of `_QUERY_TILE` queries. `leaf_size` is kept for API parity but has no
effect (there is no tree to cut off).

Matching semantics (BallTree.scala findMaximumInnerProducts): 'distance'
IS the inner product (larger = closer), not a metric distance.
ConditionalKNN restricts candidates to index points whose label is in
each query row's conditioner set (ConditionalKNN.scala:66-71); the
(queries, labels) admission table is built on the host and expanded to
the (queries, index) mask on the device, one tile at a time.

Output is columnar struct-style: for output_col 'knn', transform adds
'knn.value', 'knn.distance' (and 'knn.label' for conditional) as (n, k)
arrays — the Table analogue of the reference's array<struct> column
(ConditionalKNN.scala:55-60).

`knn_from_reference(model)` carries a fitted reference model's index
features, values (and labels) into the port's model.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..core import Estimator, Model, Param, Table
from ..core.params import HasLabelCol, in_range
from ..device import exact_f32, resolve_device
from ..ops.topk import top_k

_QUERY_TILE = 4096  # queries scored per product; bounds the q x m buffer


class _KNNParams:
    features_col = Param("features_col", "query/index feature vectors", "features")
    values_col = Param("values_col", "payload returned per neighbor", "values")
    output_col = Param("output_col", "prefix for neighbor struct columns", "output")
    k = Param("k", "number of neighbors", 5, validator=in_range(1))
    leaf_size = Param("leaf_size",
                      "ball-tree leaf size (API parity; brute-force search "
                      "has no tree)", 50)
    device = Param("device", "torch device to search on (None = the card)",
                   None)


def _top_k_inner_products(index_x: torch.Tensor, queries: np.ndarray,
                          k: int, allowed=None, label_ids=None):
    """(q, k) neighbor indices + inner products, tile by tile on
    index_x's device. `allowed` (q, L) bool and `label_ids` (m,) int64 on
    that device restrict each query to index points whose label id it
    admits."""
    dev = index_x.device
    xt = index_x.t()                                   # (d, m)
    out_vals, out_idx = [], []
    for lo in range(0, queries.shape[0], _QUERY_TILE):
        q = torch.as_tensor(np.ascontiguousarray(
            queries[lo:lo + _QUERY_TILE], np.float32), device=dev)
        with exact_f32():
            s = q @ xt                                 # (tile, m)
        if allowed is not None:
            mask = allowed[lo:lo + _QUERY_TILE][:, label_ids]
            s = s.masked_fill(~mask, float("-inf"))
        vals, idx = top_k(s, k)
        out_vals.append(vals.cpu().numpy())
        out_idx.append(idx.cpu().numpy())
    return np.concatenate(out_idx), np.concatenate(out_vals)


class _IndexHolder:
    """The fitted index features on the model's device, moved once per
    device under a lock (serving's partition workers share them)."""

    def _init_index(self):
        self._index_x = None
        self._values = None
        self._bound = None
        self._bound_lock = threading.Lock()

    def _index_on(self, dev: torch.device) -> torch.Tensor:
        with self._bound_lock:
            if self._bound is None or self._bound[0] != dev:
                self._bound = (dev, torch.as_tensor(np.ascontiguousarray(
                    self._index_x, np.float32), device=dev))
            return self._bound[1]


class KNN(Estimator, _KNNParams):
    """Index an (n, d) features column for exact top-k MIPS queries
    (reference: nn/KNN.scala:19-72)."""

    def _fit(self, t: Table) -> "KNNModel":
        x = np.ascontiguousarray(np.asarray(t[self.features_col]), np.float32)
        if x.ndim != 2:
            raise ValueError(
                f"KNN features column {self.features_col!r} must be (n, d), "
                f"got shape {x.shape}")
        m = KNNModel(**{p: getattr(self, p) for p in
                        ("features_col", "values_col", "output_col", "k",
                         "leaf_size", "device")})
        m._index_x = x
        m._values = np.asarray(t[self.values_col])
        return m


class KNNModel(Model, _KNNParams, _IndexHolder):
    """Scores queries against the fitted index (reference: nn/KNN.scala:74-126)."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._init_index()

    def _get_state(self):
        return {"index_x": self._index_x, "values": self._values}

    def _set_state(self, s):
        self._index_x = np.asarray(s["index_x"])
        self._values = np.asarray(s["values"])
        self._bound = None

    def _transform(self, t: Table) -> Table:
        q = np.asarray(t[self.features_col], np.float32)
        xi = self._index_on(resolve_device(self.device))
        idx, dist = _top_k_inner_products(xi, q, self.k)
        o = self.output_col
        return t.with_columns({f"{o}.value": self._values[idx],
                               f"{o}.distance": dist.astype(np.float64)})


class ConditionalKNN(Estimator, _KNNParams, HasLabelCol):
    """KNN restricted per query to index points whose label is in the query's
    conditioner set (reference: nn/ConditionalKNN.scala:20-63)."""
    label_col = Param("label_col", "index label column", "labels")
    conditioner_col = Param(
        "conditioner_col",
        "query column of label collections; only index points with a label "
        "in the row's collection are returned", "conditioner")

    def _fit(self, t: Table) -> "ConditionalKNNModel":
        x = np.ascontiguousarray(np.asarray(t[self.features_col]), np.float32)
        if x.ndim != 2:
            raise ValueError(
                f"ConditionalKNN features column {self.features_col!r} must "
                f"be (n, d), got shape {x.shape}")
        m = ConditionalKNNModel(**{p: getattr(self, p) for p in
                                   ("features_col", "values_col", "output_col",
                                    "k", "leaf_size", "label_col",
                                    "conditioner_col", "device")})
        m._index_x = x
        m._values = np.asarray(t[self.values_col])
        m._labels = np.asarray(t[self.label_col])
        return m


class ConditionalKNNModel(Model, _KNNParams, HasLabelCol, _IndexHolder):
    label_col = Param("label_col", "index label column", "labels")
    conditioner_col = Param("conditioner_col", "query label-collection column",
                            "conditioner")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._init_index()
        self._labels = None

    def _get_state(self):
        return {"index_x": self._index_x, "values": self._values,
                "labels": self._labels}

    def _set_state(self, s):
        self._index_x = np.asarray(s["index_x"])
        self._values = np.asarray(s["values"])
        self._labels = np.asarray(s["labels"])
        self._bound = None

    def allowed_mask(self, conditioners) -> tuple:
        """((q, L) bool admission table, (m,) label id of each index
        point): row i admits label level j when the level is in row i's
        conditioner collection. Vectorized: every row's conditioner
        values flattened once, mapped to label levels with one
        searchsorted and scattered; values not in the index drop out."""
        uniq, label_ids = np.unique(self._labels, return_inverse=True)
        per_row = [np.atleast_1d(c) for c in conditioners]
        lens = np.asarray([p.size for p in per_row])
        allowed = np.zeros((len(per_row), len(uniq)), dtype=bool)
        if lens.sum() and len(uniq):   # empty index -> all-False mask
            flat = np.concatenate(per_row)
            rows = np.repeat(np.arange(len(per_row)), lens)
            pos = np.searchsorted(uniq, flat)
            pos_c = np.clip(pos, 0, len(uniq) - 1)
            ok = uniq[pos_c] == flat   # drops values not in the index
            allowed[rows[ok], pos_c[ok]] = True
        return allowed, label_ids.reshape(-1).astype(np.int64)

    def _transform(self, t: Table) -> Table:
        q = np.asarray(t[self.features_col], np.float32)
        dev = resolve_device(self.device)
        allowed, label_ids = self.allowed_mask(t[self.conditioner_col])
        idx, dist = _top_k_inner_products(
            self._index_on(dev), q, self.k,
            torch.as_tensor(allowed, device=dev),
            torch.as_tensor(label_ids, device=dev))
        o = self.output_col
        # queries whose conditioner admits < k points get -inf distances for
        # the missing slots (reference returns a short Seq; columnar output
        # keeps static shapes)
        return t.with_columns({f"{o}.value": self._values[idx],
                               f"{o}.distance": dist.astype(np.float64),
                               f"{o}.label": self._labels[idx]})


def knn_from_reference(ref_model, cls=None, **params):
    """A port model holding a fitted reference KNN or ConditionalKNN
    model's index features, values (and labels), copied. `cls` (default:
    the port's class of the same name) picks the port class; `params` set
    its Params (e.g. `device`)."""
    if cls is None:
        cls = ConditionalKNNModel if hasattr(ref_model, "_labels") \
            else KNNModel
    m = cls(**params)
    m._set_state({k: np.array(v) for k, v in ref_model._get_state().items()})
    return m
