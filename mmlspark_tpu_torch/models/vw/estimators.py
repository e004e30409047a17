"""VW estimator stages (reference: vw/VowpalWabbitClassifier.scala,
VowpalWabbitRegressor.scala, VowpalWabbitContextualBandit.scala,
vw/VowpalWabbitBaseModel.scala).

Port of the reference's `models/vw/estimators.py`. The param surface
mirrors the reference's VW CLI passthrough where it maps cleanly
(num_passes, learning_rate, l1/l2, num_bits, power_t, initial_t);
`get_performance_statistics` returns the TrainingStats table
(VowpalWabbitBase.scala:27-46). Estimators and models take a `device`
Param (None = the card); a fit runs there (`learner.fit_vw`), and a
model scores there with its weights resident, copied once per device.
`mesh` (transient) places a fit's positions, e.g. four positions of one
card, `data_mesh(devices=[torch.device("cuda")] * 4)`.

The models' `_serving_kernel` is the sparse-pair scorer the serving plan
(`io/plan.py`) feeds (rows, k)-bucketed `(idx, val)` arrays; the bandit
model's action-crossed scoring has none and serves through the Table
path. `vw_from_reference(model)` carries a fitted reference model's
weights, bias, stats and params into the port's model.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ...core import (Estimator, HasFeaturesCol, HasLabelCol,
                     HasPredictionCol, HasProbabilitiesCol, HasWeightCol,
                     Model, Param, Table, one_of)
from ...device import resolve_device
from .featurizer import VowpalWabbitFeaturizer
from .learner import VWParams, _predict_sparse, fit_vw, predict_vw


class _VWParamsMixin(HasFeaturesCol, HasLabelCol, HasWeightCol,
                     HasPredictionCol):
    num_bits = Param("num_bits", "feature-space bits", 18)
    num_passes = Param("num_passes", "passes over the data", 1)
    learning_rate = Param("learning_rate", "SGD learning rate", 0.5)
    power_t = Param("power_t", "lr decay exponent", 0.5)
    initial_t = Param("initial_t", "lr schedule offset", 0.0)
    l1 = Param("l1", "L1 regularization", 0.0)
    l2 = Param("l2", "L2 regularization", 0.0)
    mode = Param("mode", "adaptive|sgd|bfgs (VW defaults to --adaptive)",
                 "adaptive", validator=one_of("sgd", "adaptive", "bfgs"))
    batch_size = Param("batch_size",
                       "minibatch size (1 = exact VW serial)", 256)
    bfgs_iters = Param("bfgs_iters", "L-BFGS iterations", 25)
    num_tasks = Param("num_tasks", "worker count (0 = all mesh devices)", 0)
    initial_model = Param("initial_model", "(weights, bias) warm start", None,
                          transient=True)
    device = Param("device", "torch device to fit and score on "
                   "(None = the card)", None)
    mesh = Param("mesh", "data mesh whose positions a fit shards over "
                 "(None = num_tasks positions)", None, transient=True)

    def _vw_params(self, loss: str) -> VWParams:
        return VWParams(num_bits=self.num_bits, loss_function=loss,
                        learning_rate=self.learning_rate, power_t=self.power_t,
                        initial_t=self.initial_t, l1=self.l1, l2=self.l2,
                        num_passes=self.num_passes, batch_size=self.batch_size,
                        mode=self.mode, bfgs_iters=self.bfgs_iters)

    def _fit_kw(self) -> dict:
        return dict(num_tasks=self.num_tasks, device=self.device,
                    mesh=self.mesh)

    def _features(self, t: Table):
        fc = self.features_col
        if f"{fc}_idx" in t:
            return np.asarray(t[f"{fc}_idx"]), np.asarray(t[f"{fc}_val"])
        # dense features: treat each column slot as its own hashed feature
        x = np.asarray(t[fc], np.float32)
        if x.ndim != 2:
            x = x.reshape(len(t), -1)
        feat = VowpalWabbitFeaturizer(input_cols=[fc], output_col="__vw",
                                      num_bits=self.num_bits)
        out = feat.transform(Table({fc: x}))
        return np.asarray(out["__vw_idx"]), np.asarray(out["__vw_val"])


class _VWModelBase(Model, HasFeaturesCol, HasPredictionCol):
    num_bits = Param("num_bits", "feature-space bits", 18)
    device = Param("device", "torch device to score on (None = the card)",
                   None)

    def __init__(self, weights=None, bias: float = 0.0,
                 stats: Optional[dict] = None, **kw):
        super().__init__(**kw)
        self._weights = weights
        self._bias = bias
        self._stats = stats or {}
        self._resident: dict = {}   # device -> the weights there
        self._resident_lock = threading.Lock()

    def _get_state(self):
        import json
        return {"weights": np.asarray(self._weights),
                "bias": np.float64(self._bias),
                "stats": json.dumps(self._stats)}

    def _set_state(self, s):
        import json
        self._weights = np.asarray(s["weights"])
        self._bias = float(np.asarray(s["bias"]))
        raw = s.get("stats")
        self._stats = json.loads(raw) if isinstance(raw, str) else {}
        self._resident = {}
        self._resident_lock = threading.Lock()

    def _device_weights(self, dev: torch.device) -> torch.Tensor:
        """The weights on `dev`, copied there once per model."""
        key = str(dev)
        with self._resident_lock:
            w = self._resident.get(key)
            if w is None:
                w = torch.as_tensor(np.asarray(self._weights, np.float32)
                                    ).to(dev)
                self._resident[key] = w
        return w

    def _predict(self, idx, val, link: Optional[str] = None) -> np.ndarray:
        dev = resolve_device(self.device)
        return predict_vw(self._device_weights(dev), self._bias, idx, val,
                          link=link, device=dev)

    def get_performance_statistics(self) -> Table:
        """reference: VowpalWabbitBaseModel.getPerformanceStatistics"""
        keys = sorted(self._stats)
        return Table({k: np.asarray([self._stats[k]]
                                    if not isinstance(self._stats[k], list)
                                    else [self._stats[k][-1]])
                      for k in keys})

    def _features(self, t: Table):
        return _VWParamsMixin._features(self, t)

    def _sparse_link(self) -> Optional[str]:
        """Link applied by the serving kernel; overridden per family."""
        return None

    def _serving_kernel(self, output_col: str):
        """Sparse-pair scorer for the serving fast path.

        Marked `sparse_pairs=True`: `ServingTransform` feeds it
        (rows, k)-bucketed int32/float32 host arrays when its input_cols
        are the `<f>_idx`/`<f>_val` pair. The weights stay resident on the
        model's device (copied once, when the kernel is built); each call
        moves the bucket's pairs there, gathers, and returns host float64
        (the class id for the classifier, as `_transform`'s prediction
        column)."""
        del output_col
        dev = resolve_device(self.device)
        weights = self._device_weights(dev)
        bias = torch.tensor(float(np.float32(self._bias)),
                            dtype=torch.float32, device=dev)
        link = self._sparse_link()

        def kernel(idx, val):
            with torch.no_grad():
                score = _predict_sparse(
                    weights, bias, torch.as_tensor(idx).to(dev),
                    torch.as_tensor(val).to(dev), link=link)
            score = score.cpu().numpy()
            if link == "logistic":
                return (score > 0.5).astype(np.float64)
            return score.astype(np.float64)

        kernel.sparse_pairs = True
        return kernel


def _attach_observability(est, model, idx, val) -> None:
    """Quality + lineage stamps on a fresh VW fit, as the GBDT estimators
    stamp theirs: a drift reference over the PREDICTION column (hashed
    idx/val matrices have no stable per-column identity to profile) and a
    lineage record journaled to the run ledger. Never fails a fit."""
    try:
        import hashlib
        import json

        from ...telemetry import lineage as tlineage
        from ...telemetry.quality import DatasetProfile
        head = slice(0, 8192)
        pred_t = model.transform(
            Table({f"{model.features_col}_idx": idx[head],
                   f"{model.features_col}_val": val[head]}))
        pred = np.asarray(pred_t[model.prediction_col], np.float64)
        model.quality_profile = DatasetProfile.fit(
            {"prediction": pred}).state()
        params = {}
        for pname, p in type(est).params().items():
            if p.transient:
                continue
            v = est.get_or_default(pname)
            try:
                json.dumps(v)
                params[pname] = v
            except (TypeError, ValueError):
                params[pname] = repr(v)
        lineage = {"estimator": type(est).__name__, "uid": est.uid,
                   "params": params}
        canon = json.dumps(model.quality_profile, sort_keys=True,
                           default=str)
        lineage["reference_profile"] = hashlib.sha256(
            canon.encode()).hexdigest()[:12]
        model.lineage = lineage
        ledger = tlineage.get_run_ledger()
        if ledger is not None:
            ledger.append(
                tlineage.model_version(model, content=True).export())
    except Exception:  # noqa: BLE001 - observability never fails a fit
        pass


def _row_weights(est, t: Table):
    return (np.asarray(t[est.weight_col], np.float32)
            if est.weight_col and est.weight_col in t else None)


class VowpalWabbitRegressor(Estimator, _VWParamsMixin):
    def _fit(self, t: Table) -> "VowpalWabbitRegressionModel":
        idx, val = self._features(t)
        y = np.asarray(t[self.label_col], np.float32)
        weights, bias, stats = fit_vw(idx, val, y, self._vw_params("squared"),
                                      weights=_row_weights(self, t),
                                      initial_model=self.initial_model,
                                      **self._fit_kw())
        model = VowpalWabbitRegressionModel(
            weights=weights, bias=bias, stats=stats,
            features_col=self.features_col, prediction_col=self.prediction_col,
            num_bits=self.num_bits, device=self.device)
        _attach_observability(self, model, idx, val)
        return model


class VowpalWabbitRegressionModel(_VWModelBase):
    def _transform(self, t: Table) -> Table:
        idx, val = self._features(t)
        pred = self._predict(idx, val)
        return t.with_column(self.prediction_col, pred.astype(np.float64))


class VowpalWabbitClassifier(Estimator, _VWParamsMixin, HasProbabilitiesCol):
    """Binary classifier with --loss_function logistic --link logistic."""

    def _fit(self, t: Table) -> "VowpalWabbitClassificationModel":
        idx, val = self._features(t)
        y = np.asarray(t[self.label_col], np.float32)
        weights, bias, stats = fit_vw(idx, val, y,
                                      self._vw_params("logistic"),
                                      weights=_row_weights(self, t),
                                      initial_model=self.initial_model,
                                      **self._fit_kw())
        model = VowpalWabbitClassificationModel(
            weights=weights, bias=bias, stats=stats,
            features_col=self.features_col, prediction_col=self.prediction_col,
            probabilities_col=self.probabilities_col, num_bits=self.num_bits,
            device=self.device)
        _attach_observability(self, model, idx, val)
        return model


class VowpalWabbitClassificationModel(_VWModelBase, HasProbabilitiesCol):
    def _sparse_link(self) -> Optional[str]:
        return "logistic"

    def _transform(self, t: Table) -> Table:
        idx, val = self._features(t)
        p1 = self._predict(idx, val, link="logistic")
        proba = np.stack([1 - p1, p1], axis=1)
        return (t.with_column(self.probabilities_col, proba)
                 .with_column(self.prediction_col,
                              (p1 > 0.5).astype(np.float64)))


def _action_indices(idx: np.ndarray, action: np.ndarray,
                    num_bits: int) -> np.ndarray:
    """The action-crossed feature space: hashed indices offset per action
    (0-based) so each action learns its own slice (VW's per-action
    namespaces)."""
    mask = (1 << num_bits) - 1
    return ((idx.astype(np.int64) * 31 + (action + 1) * 0x9E3779B9)
            & mask).astype(np.int32)


class VowpalWabbitContextualBandit(Estimator, _VWParamsMixin):
    """IPS-weighted contextual-bandit cost regression (reference:
    vw/VowpalWabbitContextualBandit.scala:374, cb_adf style with shared +
    per-action features).

    Expects columns: features (shared context), `chosen_action_col`
    (1-based int like VW), `cost_col` (a.k.a. label), `probability_col`
    (logging propensity). Trains a cost model on (context, action) pairs
    weighted by 1/probability; scoring emits per-action predicted costs.
    """
    num_actions = Param("num_actions", "action count", 2)
    chosen_action_col = Param("chosen_action_col", "1-based chosen action",
                              "chosen_action")
    cost_col = Param("cost_col", "observed cost of the chosen action", "cost")
    probability_col = Param("probability_col", "logging propensity",
                            "probability")

    def _cb_arrays(self, t: Table):
        """Shared featurization for fit/parallel_fit: computed ONCE per
        table however many policies sweep over it."""
        idx, val = self._features(t)
        action = np.asarray(t[self.chosen_action_col]).astype(int) - 1
        cost = np.asarray(t[self.cost_col], np.float32)
        prob = np.clip(np.asarray(t[self.probability_col], np.float32),
                       1e-3, 1.0)
        a_idx = _action_indices(idx, action[:, None], self.num_bits)
        return a_idx, val, cost, prob

    def _fit_arrays(self, est, a_idx, val, cost, prob):
        weights, bias, stats = fit_vw(
            a_idx, val, cost, est._vw_params("squared"),
            weights=1.0 / prob, **est._fit_kw())
        # IPS / SNIPS diagnostics (TrainingStats ipsEstimate/snipsEstimate)
        ips_terms = cost / prob
        stats["ips_estimate"] = float(np.mean(ips_terms))
        stats["snips_estimate"] = float(ips_terms.sum()
                                        / max((1 / prob).sum(), 1e-9))
        m = VowpalWabbitContextualBanditModel(
            weights=weights, bias=bias, stats=stats,
            features_col=est.features_col, prediction_col=est.prediction_col,
            num_bits=est.num_bits, device=est.device)
        m.set(num_actions=est.num_actions)
        return m

    def _fit(self, t: Table) -> "VowpalWabbitContextualBanditModel":
        return self._fit_arrays(self, *self._cb_arrays(t))

    def parallel_fit(self, t: Table, param_maps):
        """Multi-policy sweep (reference: parallelFit,
        vw/VowpalWabbitContextualBandit.scala — one CB model per ParamMap,
        for policy evaluation).

        param_maps: list of {param_name: value} overrides (e.g. sweeping
        learning_rate / l2 / num_passes). Featurization is computed once
        and shared; returns models in param_maps order, each carrying its
        own ips_estimate / snipsEstimate in get_performance_statistics().
        The fits run one after another on the card: threads sharing one
        card made the sweep slower, not faster."""
        arrays = self._cb_arrays(t)
        # everything baked into the shared arrays must not vary inside a
        # sweep: feature hashing AND the logged-data columns (an override
        # of these would be silently ignored: arrays are computed once)
        frozen = ("num_bits", "features_col", "chosen_action_col",
                  "cost_col", "probability_col")
        for pm in param_maps:
            bad = [k for k in pm if k in frozen]
            if bad:
                raise ValueError(
                    f"parallel_fit shares one featurization; {bad} cannot "
                    "vary per policy — run separate fits instead")
        return [self._fit_arrays(self.copy(pm), *arrays)
                for pm in param_maps]


class VowpalWabbitContextualBanditModel(_VWModelBase):
    num_actions = Param("num_actions", "action count", 2)

    # action-crossed scoring doesn't fit the single-margin kernel; the
    # Table path serves bandit models
    _serving_kernel = None

    def _transform(self, t: Table) -> Table:
        idx, val = self._features(t)
        scores = [self._predict(_action_indices(idx, np.int64(a),
                                                self.num_bits), val)
                  for a in range(self.num_actions)]
        score_mat = np.stack(scores, axis=1)  # (n, A) predicted costs
        return (t.with_column("action_scores", score_mat)
                 .with_column(self.prediction_col,
                              score_mat.argmin(axis=1).astype(np.float64)
                              + 1))


_MODEL_CLASSES = {c.__name__: c for c in (VowpalWabbitClassificationModel,
                                          VowpalWabbitRegressionModel,
                                          VowpalWabbitContextualBanditModel)}


def vw_from_reference(ref_model, cls=None, **params):
    """A port model holding a fitted reference VW model's weights, bias
    and stats (copied) and its Params. `cls` (default: the port's class of
    the same name) picks the port class; `params` set its Params (e.g.
    `device`)."""
    if cls is None:
        cls = _MODEL_CLASSES[type(ref_model).__name__]
    carried = {}
    for name in cls.params():
        if hasattr(ref_model, "is_set") and ref_model.has_param(name) \
                and ref_model.is_set(name):
            carried[name] = ref_model.get(name)
    m = cls(**{**carried, **params})
    m._set_state({k: (v if isinstance(v, str) else np.array(v))
                  for k, v in ref_model._get_state().items()})
    return m
