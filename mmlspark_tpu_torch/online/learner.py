"""Incremental VW learner on a fixed shape bucket.

Port of the reference's `online/learner.py`. `OnlineLearner` carries the
mutable training state the batch `fit_vw` path hides: hashed weights,
bias and the AdaGrad accumulator, updated one minibatch at a time. Here
that state lives on the learner's device (None = the card) as tensors;
`snapshot`, `restore` and `make_model` copy it to and from host numpy.

Every `partial_fit` pads its rows to ONE canonical (rows, k) shape
bucket, so every update (warm-start, steady stream, post-refit) runs the
same kernels at the same shapes. Padding follows the batch learner's
convention: padded pairs carry `val == 0` (no gradient) and padded rows
`w == 0` (no loss), so a padded minibatch computes the same update as the
ragged one.

`_online_update` is the batch learner's minibatch step
(`models.vw.learner._sgd_batch`, adaptive mode) with the accumulator
carried in instead of zero-initialized, which is what makes the update
incremental across refits. It launches no float atomics, so two learners
fed equal chunks end bit-identical on the card, and a refit retried from
a snapshot reaches the clean run's weights exactly. A chunk's one host
read is its loss.

Each `make_model()` is a content-addressed candidate: a normal
`VowpalWabbit*Model` stamped with online lineage, its `ModelVersion`
journaled to the run ledger when one is configured.

The reference's `online_update_contract` (a JAX lowering contract) is
ROADMAP Queue 1 item 24 and raises NotImplementedError.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.vw.learner import VWParams, _predict_sparse, _sgd_batch
from ..reliability.metrics import reliability_metrics
from ..stages.batching import shape_bucket
from ..telemetry import names as tnames


def __getattr__(name: str):
    if name == "online_update_contract":
        raise NotImplementedError(
            "online.learner.online_update_contract is the reference's JAX "
            "lowering contract, not ported yet (ROADMAP Queue 1 item 24)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _online_update(idx, val, y, w, weights, bias, acc, lr, l2,
                   loss_function="logistic"):
    """One AdaGrad minibatch update at a fixed (rows, k) shape: (weights,
    bias, acc, mean loss), tensors on the inputs' device."""
    p = VWParams(num_bits=int(weights.shape[0]).bit_length() - 1,
                 loss_function=loss_function, learning_rate=float(lr),
                 l2=float(l2), mode="adaptive")
    t = torch.zeros((), dtype=torch.float32, device=weights.device)
    weights, bias, acc, _, loss = _sgd_batch(weights, bias, acc, t, idx, val,
                                             y, w, p, None)
    return weights, bias, acc, loss / torch.clamp(w.sum(), min=1.0)


class OnlineLearner:
    """Incremental VW training state with snapshot/rewind.

    Parameters
    ----------
    params:      `VWParams`: `loss_function` picks the model family
                 (`logistic` -> classifier, `squared` -> regressor);
                 `learning_rate`/`l2`/`num_bits` apply per minibatch.
                 The online path is always adaptive (AdaGrad): the mode
                 whose accumulator makes warm-started incremental
                 updates well-behaved.
    warm_start:  incumbent `VowpalWabbit*Model` (or `(weights, bias)`)
                 whose weights seed the learner. The AdaGrad accumulator
                 starts at zero and is carried across every refit.
    rows:        the fixed row bucket every minibatch is padded to.
    k:           the fixed pairs-per-row bucket; inferred (power of two)
                 from the first minibatch when None, frozen after.
    device:      where the state lives and updates run (None = the card).
    """

    MAX_K = 1024

    def __init__(self, params: Optional[VWParams] = None, *,
                 warm_start=None, rows: int = 256, k: Optional[int] = None,
                 metrics=None, device=None):
        self.params = params or VWParams(loss_function="logistic")
        self.rows = max(int(rows), 1)
        self._k = None if k is None else shape_bucket(int(k), self.MAX_K)
        self._metrics = metrics if metrics is not None \
            else reliability_metrics
        self.device = resolve_device(device)
        dim = 1 << self.params.num_bits
        weights, bias = np.zeros(dim, np.float32), 0.0
        if warm_start is not None:
            if hasattr(warm_start, "_weights"):
                weights = np.asarray(warm_start._weights, np.float32)
                bias = float(warm_start._bias)
            else:
                weights, bias = warm_start
                weights = np.asarray(weights, np.float32)
                bias = float(bias)
            if weights.shape[0] != dim:
                raise ValueError(
                    f"warm-start weights have {weights.shape[0]} slots, "
                    f"params.num_bits={self.params.num_bits} needs {dim}")
        self._set(weights, np.float32(bias), np.zeros(dim, np.float32))
        self.updates = 0        # minibatch updates applied
        self.examples = 0       # live (unpadded) rows consumed
        self.refits = 0         # make_model() candidates produced
        self.last_loss: Optional[float] = None

    def _set(self, weights, bias, acc) -> None:
        dev = self.device
        self._weights = torch.as_tensor(np.array(weights, np.float32)).to(dev)
        self._bias = torch.tensor(float(bias), dtype=torch.float32,
                                  device=dev)
        self._acc = torch.as_tensor(np.array(acc, np.float32)).to(dev)

    # -- shape discipline -----------------------------------------------------
    def _bucket(self, idx: np.ndarray, val: np.ndarray):
        """Freeze k on first contact, then pad pairs out to it. Padded
        pairs use idx 0 / val 0: zero gradient, zero score."""
        if self._k is None:
            self._k = shape_bucket(max(idx.shape[1], 1), self.MAX_K)
        if idx.shape[1] > self._k:
            raise ValueError(
                f"minibatch has {idx.shape[1]} pairs/row; this learner's "
                f"frozen k bucket is {self._k}")
        pad = self._k - idx.shape[1]
        if pad:
            idx = np.pad(idx, ((0, 0), (0, pad)))
            val = np.pad(val, ((0, 0), (0, pad)))
        return idx, val

    @property
    def k(self) -> Optional[int]:
        return self._k

    # -- the update -----------------------------------------------------------
    def partial_fit(self, idx, val, y, w=None) -> dict:
        """Fold a ragged minibatch of hashed sparse pairs into the
        learner. Rows are chunked and padded to the fixed (rows, k)
        bucket; every chunk is one `_online_update` at that shape."""
        idx = np.asarray(idx, np.int32)
        val = np.asarray(val, np.float32)
        y = np.asarray(y, np.float32).reshape(-1)
        if idx.ndim != 2 or idx.shape != val.shape:
            raise ValueError("idx/val must be matching (n, k) arrays")
        if idx.shape[0] != y.shape[0]:
            raise ValueError("idx/val and y row counts differ")
        w = (np.ones_like(y) if w is None
             else np.asarray(w, np.float32).reshape(-1))
        idx, val = self._bucket(idx, val)
        lr = np.float32(self.params.learning_rate)
        l2 = np.float32(self.params.l2)
        dev = self.device
        total_loss, chunks = 0.0, 0
        for start in range(0, idx.shape[0], self.rows):
            ci, cv = idx[start:start + self.rows], val[start:start + self.rows]
            cy, cw = y[start:start + self.rows], w[start:start + self.rows]
            live = ci.shape[0]
            if live < self.rows:
                pad = ((0, self.rows - live), (0, 0))
                ci, cv = np.pad(ci, pad), np.pad(cv, pad)
                cy = np.pad(cy, (0, self.rows - live))
                cw = np.pad(cw, (0, self.rows - live))   # w=0: no loss
            with torch.no_grad():
                self._weights, self._bias, self._acc, loss = _online_update(
                    *(torch.as_tensor(a).to(dev) for a in (ci, cv, cy, cw)),
                    self._weights, self._bias, self._acc, lr, l2,
                    loss_function=self.params.loss_function)
            total_loss += float(loss)    # the chunk's one host read
            chunks += 1
            self.updates += 1
            self.examples += int(live)
            self._metrics.inc(tnames.ONLINE_LEARNER_UPDATES)
        self.last_loss = total_loss / max(chunks, 1)
        return {"updates": chunks, "examples": int(y.shape[0]),
                "loss": self.last_loss}

    def predict(self, idx, val, link: Optional[str] = None) -> np.ndarray:
        """Host scores of host (idx, val) rows under the current state."""
        dev = self.device
        with torch.no_grad():
            score = _predict_sparse(
                self._weights, self._bias,
                torch.as_tensor(np.asarray(idx, np.int32)).to(dev),
                torch.as_tensor(np.asarray(val, np.float32)).to(dev),
                link=link)
        return score.cpu().numpy()

    # -- snapshot / rewind ----------------------------------------------------
    def snapshot(self) -> dict:
        """Host copy of everything a failed refit must rewind."""
        return {"weights": self._weights.cpu().numpy().copy(),
                "bias": np.float32(self._bias.cpu()),
                "acc": self._acc.cpu().numpy().copy(),
                "updates": self.updates, "examples": self.examples,
                "refits": self.refits, "last_loss": self.last_loss}

    def restore(self, snap: dict) -> None:
        self._set(snap["weights"], snap["bias"], snap["acc"])
        self.updates = snap["updates"]
        self.examples = snap["examples"]
        self.refits = snap["refits"]
        self.last_loss = snap["last_loss"]

    # -- candidate production -------------------------------------------------
    def make_model(self, features_col: str = "features",
                   prediction_col: str = "prediction",
                   reference_profile: Optional[dict] = None,
                   reason: Optional[str] = None):
        """Freeze the current state into a content-addressed candidate.

        Returns a plain `VowpalWabbit*Model` (classification for logistic
        loss, regression for squared) on the learner's device, stamped
        with online lineage; its `ModelVersion` is journaled to the run
        ledger when one is configured, the record batch fits stamp."""
        from ..models.vw.estimators import (VowpalWabbitClassificationModel,
                                            VowpalWabbitRegressionModel)
        stats = {"passes": 0, "online_updates": self.updates,
                 "online_examples": self.examples,
                 "final_loss": self.last_loss}
        kw = dict(weights=self._weights.cpu().numpy().copy(),
                  bias=float(self._bias.cpu()), stats=stats,
                  features_col=features_col, prediction_col=prediction_col,
                  num_bits=self.params.num_bits, device=str(self.device))
        if self.params.loss_function == "logistic":
            model = VowpalWabbitClassificationModel(**kw)
        else:
            model = VowpalWabbitRegressionModel(**kw)
        self.refits += 1
        lineage = {"estimator": "OnlineLearner",
                   "loss_function": self.params.loss_function,
                   "refit": self.refits, "updates": self.updates,
                   "examples": self.examples, "loss": self.last_loss}
        if reason is not None:
            lineage["reason"] = reason
        model.lineage = lineage
        if reference_profile is not None:
            model.quality_profile = reference_profile
        from ..telemetry import lineage as tlineage
        ledger = tlineage.get_run_ledger()
        if ledger is not None:
            ledger.append(
                tlineage.model_version(model, content=True).export())
        return model
