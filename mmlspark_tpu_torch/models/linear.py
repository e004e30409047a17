"""Linear learners (logistic and linear regression) on the card.

Port of `mmlspark_tpu/models/linear.py`, the stand-ins for the SparkML
learners the reference's AutoTrain and AutoML wrap (TrainClassifier's
default learner is logistic regression, train/TrainClassifier.scala:49).

The reference fits with one jitted `lax.scan` of `optax.adam` steps over
the full batch. Here the same steps are a host loop on the card: each
step is a fixed sequence of launches (the logits, the loss's gradient in
closed form, the weight gradient, Adam on `w` and `b`) with no host read
inside the loop. The loss is the reference's: the weighted mean
`sum(ll * w) / sum(w)` of sigmoid cross-entropy (two classes), softmax
cross-entropy (more) or half the squared error (regression), plus
`reg_param` times the sum of squares of every parameter, the bias
included. Adam is `optax.adam`'s: b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias corrections `1 - b**t` in float32.

Features are a dense (n, F) matrix or the sparse pair columns
`<features>_idx`/`<features>_val` (ops/sparse.py), whose weight rows are
gathered at `idx % width`; the width is the `logical_width` the
featurizer stamped on the idx column. The sparse weight gradient is a
deterministic scatter: the pairs' slots are sorted stably once per fit,
and each step sums each slot's contributions with two
`torch.segment_reduce` calls (chunks of at most `_CHUNK` contributions,
then each slot's chunks: a thread of the card's segmented sum adds its
run serially, and a Zipf slot's run is long), with no float atomics, so
two fits on the card give the same bits. f32 products run with TF32 off (`device.exact_f32`).

`LinearRegression(solver="normal")` forms the weighted Gram in float64
on the fit's device and solves it there; a system with an exact zero
pivot raises numpy's `LinAlgError`, as the reference's `np.linalg.solve`
does. A system that is singular only up to rounding (one-hot columns
beside the bias, no L2) is solved in both packages, with weights that
differ along its null space and predictions that agree. Models compute their logits on
their device: on the card in torch, on the CPU through the reference's
numpy formulas (`_score_linear`); probabilities follow on the host with
the reference's formulas. `linear_from_reference(model)` carries a fitted
reference model's weights, bias and Params across.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core import (Estimator, HasFeaturesCol, HasLabelCol, HasPredictionCol,
                    HasProbabilitiesCol, HasWeightCol, Model, Param, Table)
from ..device import exact_f32, resolve_device

__all__ = ["LogisticRegression", "LogisticRegressionModel",
           "LinearRegression", "LinearRegressionModel", "fit_linear",
           "linear_from_reference"]

# optax.adam's defaults
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


# longest run one thread of the segmented sum adds serially: a slot's
# contributions are summed in chunks of at most this many, then the
# chunks' sums per slot (hashed text is Zipf: its commonest token's slot
# holds ~10% of all pairs)
_CHUNK = 256


class _Sparse:
    """A fit's sparse design on one device: the gathered slots
    `idx % width` (int64), the values, the stable order that groups each
    slot's contributions, and the run lengths of the two-level segmented
    sum: chunks of at most `_CHUNK` contributions of one slot, then each
    slot's chunks. Built once per fit; every shape is fixed by the data,
    so each step's sums add in one order on every run."""

    def __init__(self, idx: torch.Tensor, val: torch.Tensor, width: int):
        self.idx = idx.to(torch.int64) % width
        self.val = val
        flat = self.idx.reshape(-1)
        dev = flat.device
        self.order = torch.sort(flat, stable=True).indices
        lengths = torch.zeros(width, dtype=torch.int64, device=dev)
        lengths.index_add_(0, flat, torch.ones_like(flat))
        slot = flat[self.order]
        start = torch.cumsum(lengths, 0) - lengths
        pos = torch.arange(len(slot), device=dev) - start[slot]
        chunk = slot * (len(slot) // _CHUNK + 1) + pos // _CHUNK
        _, self.chunk_lengths = torch.unique_consecutive(
            chunk, return_counts=True)
        self.slot_chunks = (lengths + _CHUNK - 1) // _CHUNK
        self.width = width


def _logits(w: torch.Tensor, b: torch.Tensor, x) -> torch.Tensor:
    """(n, out) logits: a dense product, or the sparse pair's gathered
    weight rows summed with their values."""
    if isinstance(x, _Sparse):
        return (x.val.unsqueeze(-1) * w[x.idx]).sum(1) + b
    return x @ w + b


def _weight_grad(x, g: torch.Tensor) -> torch.Tensor:
    """d loss / d w from the logits' gradient g (n, out)."""
    if isinstance(x, _Sparse):
        contrib = (x.val.unsqueeze(-1) * g.unsqueeze(1)).reshape(
            -1, g.shape[1])
        chunks = torch.segment_reduce(contrib[x.order], "sum",
                                      lengths=x.chunk_lengths, axis=0,
                                      unsafe=True)
        return torch.segment_reduce(chunks, "sum", lengths=x.slot_chunks,
                                    axis=0, unsafe=True)
    return x.T @ g


def _logit_grad(z: torch.Tensor, y: torch.Tensor, coef: torch.Tensor,
                kind: str) -> torch.Tensor:
    """d (sum(ll * w) / sum(w)) / d logits; coef = w / sum(w)."""
    if kind == "binary":
        g = torch.sigmoid(z[:, 0]) - y
    elif kind == "multiclass":
        g = torch.softmax(z, dim=1)
        g[torch.arange(len(y), device=z.device), y.long()] -= 1.0
        return g * coef.unsqueeze(1)
    else:
        g = z[:, 0] - y
    return (g * coef).unsqueeze(1)


def _bias_corrections(n_steps: int, decay: float) -> list:
    """optax's `1 - decay**count` in float32, count = 1..n_steps."""
    t = np.arange(1, n_steps + 1, dtype=np.float32)
    return [float(v) for v in
            np.float32(1) - np.float32(decay) ** t]


def fit_linear(x, y: torch.Tensor, w: torch.Tensor, n_steps: int,
               n_classes: int, kind: str, reg_l2: float, lr: float,
               n_features: int = 0):
    """Full-batch Adam from zeros (the reference's `_fit_linear`,
    linear.py:36-65), every tensor on one device, in y's dtype (f32 for
    the learners). x: a dense (n, F) tensor or a `_Sparse`. Returns
    (w (F, out), b (out,))."""
    dev = y.device
    f = n_features or x.shape[1]
    out_dim = n_classes if kind == "multiclass" else 1
    params = [torch.zeros((f, out_dim), dtype=y.dtype, device=dev),
              torch.zeros((out_dim,), dtype=y.dtype, device=dev)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    coef = w / w.sum()
    bc1 = _bias_corrections(n_steps, _B1)
    bc2 = _bias_corrections(n_steps, _B2)
    with exact_f32():
        for step in range(n_steps):
            pw, pb = params
            g = _logit_grad(_logits(pw, pb, x), y, coef, kind)
            grads = [_weight_grad(x, g), g.sum(0)]
            if reg_l2:
                grads = [gr + (2.0 * reg_l2) * p
                         for gr, p in zip(grads, params)]
            for i, gr in enumerate(grads):
                mu[i] = (1 - _B1) * gr + _B1 * mu[i]
                nu[i] = (1 - _B2) * (gr * gr) + _B2 * nu[i]
                upd = (mu[i] / bc1[step]) / (
                    torch.sqrt(nu[i] / bc2[step]) + _EPS)
                params[i] = params[i] + (-lr) * upd
    return params[0], params[1]


def _score_linear(t: Table, features_col: str, w: np.ndarray, b,
                  sparse_trained: bool) -> np.ndarray:
    """(n, out_dim) logits from a dense features column or a sparse pair
    (the reference's numpy formulas: the CPU path)."""
    if features_col not in t and f"{features_col}_idx" in t:
        _check_sparse(features_col, sparse_trained)
        idx = np.asarray(t[f"{features_col}_idx"], np.int64)
        val = np.asarray(t[f"{features_col}_val"], np.float32)
        width = w.shape[0]
        return np.einsum("nk,nko->no", val, w[idx % width]) + b
    x = np.asarray(t[features_col], np.float32)
    return x @ w + b


def _check_sparse(features_col: str, sparse_trained: bool) -> None:
    if not sparse_trained:
        raise TypeError(
            f"this model was trained on a dense {features_col!r} matrix; "
            f"scoring sparse pair columns would remap feature indices — "
            f"densify via ops.sparse.to_dense or retrain on sparse input")


class _LinearBase(Estimator, HasFeaturesCol, HasLabelCol, HasWeightCol,
                  HasPredictionCol):
    max_iter = Param("max_iter", "optimizer steps", 300)
    reg_param = Param("reg_param", "L2 regularization", 0.0)
    learning_rate = Param("learning_rate", "adam step size", 0.1)
    device = Param("device", "torch device to fit and score on "
                   "(None = the card)", None)

    def _data(self, t: Table, dev: torch.device):
        fc = self.features_col
        if fc not in t and f"{fc}_idx" in t:
            x = (torch.as_tensor(np.asarray(t[f"{fc}_idx"], np.int32)
                                 ).to(dev),
                 torch.as_tensor(np.asarray(t[f"{fc}_val"], np.float32)
                                 ).to(dev))
        else:
            x = torch.as_tensor(np.asarray(t[fc], np.float32)).to(dev)
        y = torch.as_tensor(np.asarray(t[self.label_col], np.float32)
                            ).to(dev)
        if self.weight_col and self.weight_col in t:
            w = torch.as_tensor(np.asarray(t[self.weight_col], np.float32)
                                ).to(dev)
        else:
            w = torch.ones(len(y), dtype=torch.float32, device=dev)
        return x, y, w

    def _table_width(self, t: Table, x) -> int:
        """Weight-table rows: F for dense; for sparse, the logical width the
        featurizer stamped on the idx column's metadata (falling back to the
        observed max with a warning — sample-dependent widths risk serve-time
        wrapping onto unrelated features)."""
        if not isinstance(x, tuple):
            return int(x.shape[1])
        meta_width = t.column_meta(
            f"{self.features_col}_idx").get("logical_width")
        if meta_width:
            return int(meta_width)
        idx = np.asarray(t[f"{self.features_col}_idx"])
        if idx.size == 0:
            return 1
        warnings.warn(
            f"sparse column {self.features_col!r}_idx carries no "
            f"logical_width metadata; sizing the weight table from the "
            f"observed max index — serve-time indices beyond it will wrap",
            stacklevel=3)
        return int(idx.max()) + 1

    def _fit_adam(self, t: Table, x, y, w, n_classes: int, kind: str):
        width = self._table_width(t, x)
        design = _Sparse(x[0], x[1], width) if isinstance(x, tuple) else x
        pw, pb = fit_linear(design, y, w, self.max_iter, n_classes, kind,
                            self.reg_param, self.learning_rate,
                            n_features=width)
        return pw.cpu().numpy(), pb.cpu().numpy()


class _LinearModelBase(Model, HasFeaturesCol, HasPredictionCol):
    sparse_trained = Param("sparse_trained",
                           "model was fit on sparse pair columns", False)
    device = Param("device", "torch device to score on (None = the card)",
                   None)

    def __init__(self, **kw):
        super().__init__(**kw)
        self._w = self._b = None
        self._resident = None   # (device, w, b) on that device

    def _w2(self) -> np.ndarray:
        return self._w

    def _logits(self, t: Table) -> np.ndarray:
        """(n, out) f32 logits: on the CPU through the reference's numpy
        formulas, on the card as torch products (copied back)."""
        dev = resolve_device(self.device)
        if dev.type == "cpu":
            return _score_linear(t, self.features_col, self._w2(), self._b,
                                 self.sparse_trained)
        res = self._resident
        if res is None or res[0] != dev:
            res = (dev, torch.as_tensor(self._w2()).to(dev),
                   torch.as_tensor(np.asarray(self._b, np.float32)).to(dev))
            self._resident = res
        _, w, b = res
        fc = self.features_col
        with exact_f32():
            if fc not in t and f"{fc}_idx" in t:
                _check_sparse(fc, self.sparse_trained)
                idx = torch.as_tensor(np.asarray(t[f"{fc}_idx"], np.int64)
                                      ).to(dev) % w.shape[0]
                val = torch.as_tensor(np.asarray(t[f"{fc}_val"], np.float32)
                                      ).to(dev)
                out = (val.unsqueeze(-1) * w[idx]).sum(1) + b
            else:
                x = torch.as_tensor(np.asarray(t[fc], np.float32)).to(dev)
                out = x @ w + b
        return out.cpu().numpy()


class LogisticRegression(_LinearBase, HasProbabilitiesCol):
    num_classes = Param("num_classes", "0 = infer from labels", 0)

    def _fit(self, t: Table) -> "LogisticRegressionModel":
        dev = resolve_device(self.device)
        x, y, w = self._data(t, dev)
        k = self.num_classes or int(np.asarray(t[self.label_col]).max()) + 1
        kind = "binary" if k <= 2 else "multiclass"
        m = LogisticRegressionModel(
            features_col=self.features_col, prediction_col=self.prediction_col,
            probabilities_col=self.probabilities_col, n_classes=k,
            sparse_trained=isinstance(x, tuple), device=self.device)
        m._w, m._b = self._fit_adam(t, x, y, w, k, kind)
        return m


class LogisticRegressionModel(_LinearModelBase, HasProbabilitiesCol):
    n_classes = Param("n_classes", "number of classes", 2)

    def _get_state(self):
        return {"w": self._w, "b": self._b}

    def _set_state(self, s):
        self._w, self._b = np.asarray(s["w"]), np.asarray(s["b"])
        self._resident = None

    def _transform(self, t: Table) -> Table:
        logits = self._logits(t)
        if self.n_classes <= 2:
            p1 = 1.0 / (1.0 + np.exp(-logits[:, 0]))
            proba = np.stack([1 - p1, p1], axis=1)
        else:
            e = np.exp(logits - logits.max(1, keepdims=True))
            proba = e / e.sum(1, keepdims=True)
        return (t.with_column(self.probabilities_col, proba)
                 .with_column(self.prediction_col,
                              proba.argmax(1).astype(np.float64)))


class LinearRegression(_LinearBase):
    solver = Param("solver", "normal|sgd", "normal")

    def _fit(self, t: Table) -> "LinearRegressionModel":
        dev = resolve_device(self.device)
        x, y, w = self._data(t, dev)
        m = LinearRegressionModel(features_col=self.features_col,
                                  prediction_col=self.prediction_col,
                                  device=self.device)
        sparse = isinstance(x, tuple)
        if sparse and self.solver == "normal":
            warnings.warn(
                "solver='normal' would materialize the dense gram at the "
                "sparse logical width; using the gradient solver instead",
                stacklevel=2)
        if sparse or self.solver != "normal":
            pw, pb = self._fit_adam(t, x, y, w, 1, "regression")
            m._w = pw[:, 0]
            m._b = np.float32(pb[0])
            m.set(sparse_trained=sparse)
            return m
        # the weighted normal equations in float64, formed and solved on
        # the fit's device (reference :198-211)
        xn = x.double()
        xa = torch.cat([xn, torch.ones((len(xn), 1), dtype=torch.float64,
                                       device=dev)], dim=1)
        xtw = xa.T * w.double()
        a = xtw @ xa + self.reg_param * torch.eye(
            xa.shape[1], dtype=torch.float64, device=dev)
        beta, info = torch.linalg.solve_ex(a, xtw @ y.double())
        if int(info):   # an exact zero pivot, where numpy's solve raises
            raise np.linalg.LinAlgError("Singular matrix")
        beta = beta.cpu().numpy()
        m._w, m._b = beta[:-1].astype(np.float32), np.float32(beta[-1])
        return m


class LinearRegressionModel(_LinearModelBase):

    def _get_state(self):
        return {"w": self._w, "b": np.asarray(self._b)}

    def _set_state(self, s):
        self._w, self._b = np.asarray(s["w"]), np.float32(np.asarray(s["b"]))
        self._resident = None

    def _w2(self) -> np.ndarray:
        return self._w.reshape(-1, 1)

    def _transform(self, t: Table) -> Table:
        logits = self._logits(t)[:, 0]
        return t.with_column(self.prediction_col, logits.astype(np.float64))


_MODEL_CLASSES = {"LogisticRegressionModel": LogisticRegressionModel,
                  "LinearRegressionModel": LinearRegressionModel}


def linear_from_reference(ref_model, cls=None, **params):
    """A port model holding a fitted reference linear model's `w` and `b`
    (copied) and its Params. `cls` (default: the port's class of the same
    name) picks the port class; `params` set its Params (e.g.
    `device`)."""
    if cls is None:
        cls = _MODEL_CLASSES[type(ref_model).__name__]
    carried = {}
    for name in cls.params():
        if ref_model.has_param(name) and ref_model.is_set(name):
            carried[name] = ref_model.get(name)
    m = cls(**{**carried, **params})
    m._set_state({k: np.array(v) for k, v in ref_model._get_state().items()})
    return m
