"""TrainClassifier / TrainRegressor: wrap any learner with auto-featurization
and label indexing (reference: train/TrainClassifier.scala:49-377,
train/TrainRegressor.scala). The fitted model is featurize -> inner model ->
un-index labels, exactly the reference's TrainedClassifierModel composition.

Port of `mmlspark_tpu/train/train_classifier.py`. Featurizing and label
indexing are host code; the inner learner fits and scores on its own
device. `device`, where set, is copied onto the inner learner (and is the
default learner's device; None = the card). Save and load go through
`core/serialize.py`. `trained_from_reference(model)` carries a fitted
reference composite across: its featurizer state, its label indexer, and
its inner model (linear models through `linear_from_reference`, GBDT
through the booster's dict).
"""
from __future__ import annotations

import numpy as np

from ..core import (Estimator, Model, Param, Table, HasLabelCol)
from ..featurize.featurize import Featurize, FeaturizeModel
from ..featurize.value_indexer import ValueIndexer, ValueIndexerModel


def _with_device(inner, device_set: bool, device):
    """The inner learner with the wrapper's device, where the wrapper's is
    set and the learner has one."""
    if device_set and inner.has_param("device"):
        return inner.copy({"device": device})
    return inner


class TrainClassifier(Estimator, HasLabelCol):
    model = Param("model", "inner classifier estimator", None)
    features_col = Param("features_col", "assembled features column",
                         "__train_features")
    num_features = Param("num_features", "hash-slot override for featurize", 0)
    reindex_label = Param("reindex_label", "index non-contiguous labels", True)
    device = Param("device", "torch device of the inner learner (None = "
                   "the card; unset keeps the learner's own)", None)

    def _fit(self, t: Table) -> "TrainedClassifierModel":
        inner = self.model
        if inner is None:
            from ..models.linear import LogisticRegression
            inner = LogisticRegression(device=self.device)
        inner = _with_device(inner, self.is_set("device"), self.device)
        # label indexing (TrainClassifier.scala:91-160)
        label_model = None
        y = t[self.label_col]
        work = t
        if self.reindex_label:
            needs = (y.dtype == object
                     or not np.issubdtype(y.dtype, np.number)
                     or (np.unique(y) != np.arange(len(np.unique(y)))).any())
            if needs:
                label_model = ValueIndexer(
                    input_col=self.label_col,
                    output_col="__label_idx").fit(t)
                work = label_model.transform(t)
                work = work.drop(self.label_col).rename(
                    {"__label_idx": self.label_col})
        feat = Featurize(dense_output=True,  # inner learners take matrices
                         output_col=self.features_col,
                         label_col=self.label_col,
                         num_features=self.num_features).fit(work)
        featurized = feat.transform(work)
        inner = inner.copy({"features_col": self.features_col,
                            "label_col": self.label_col})
        fitted = inner.fit(featurized)
        m = TrainedClassifierModel(label_col=self.label_col)
        m._featurizer, m._model, m._label_model = feat, fitted, label_model
        return m


class TrainedClassifierModel(Model, HasLabelCol):
    stages = Param("stages", "nested fitted stages (persistence only)", None)

    def __init__(self, **kw):
        super().__init__(**kw)
        self._featurizer = self._model = self._label_model = None

    @property
    def inner_model(self):
        return self._model

    def _prepare_save(self):
        self.set(stages=[s for s in [self._featurizer, self._model,
                                     self._label_model] if s is not None])

    def _finish_load(self):
        stages = self.get("stages") or []
        self._featurizer = stages[0] if len(stages) > 0 else None
        self._model = stages[1] if len(stages) > 1 else None
        self._label_model = stages[2] if len(stages) > 2 else None

    def _transform(self, t: Table) -> Table:
        out = self._featurizer.transform(t)
        out = self._model.transform(out)
        if self._label_model is not None:
            # un-index predicted labels back to the original values
            levels = self._label_model._levels
            pred = np.asarray(out["prediction"]).astype(int)
            out = out.with_column("scored_labels",
                                  levels[np.clip(pred, 0, len(levels) - 1)])
        else:
            out = out.with_column("scored_labels", out["prediction"])
        return out.drop(self._featurizer.output_col)


class TrainRegressor(Estimator, HasLabelCol):
    model = Param("model", "inner regressor estimator", None)
    features_col = Param("features_col", "assembled features column",
                         "__train_features")
    num_features = Param("num_features", "hash-slot override for featurize", 0)
    device = Param("device", "torch device of the inner learner (None = "
                   "the card; unset keeps the learner's own)", None)

    def _fit(self, t: Table) -> "TrainedRegressorModel":
        inner = self.model
        if inner is None:
            from ..models.linear import LinearRegression
            inner = LinearRegression(device=self.device)
        inner = _with_device(inner, self.is_set("device"), self.device)
        feat = Featurize(dense_output=True,  # inner learners take matrices
                         output_col=self.features_col,
                         label_col=self.label_col,
                         num_features=self.num_features).fit(t)
        featurized = feat.transform(t)
        inner = inner.copy({"features_col": self.features_col,
                            "label_col": self.label_col})
        fitted = inner.fit(featurized)
        m = TrainedRegressorModel(label_col=self.label_col)
        m._featurizer, m._model = feat, fitted
        return m


class TrainedRegressorModel(Model, HasLabelCol):
    stages = Param("stages", "nested fitted stages (persistence only)", None)

    def __init__(self, **kw):
        super().__init__(**kw)
        self._featurizer = self._model = None

    def _prepare_save(self):
        self.set(stages=[self._featurizer, self._model])

    def _finish_load(self):
        stages = self.get("stages") or []
        self._featurizer = stages[0] if len(stages) > 0 else None
        self._model = stages[1] if len(stages) > 1 else None

    @property
    def inner_model(self):
        return self._model

    def _transform(self, t: Table) -> Table:
        out = self._featurizer.transform(t)
        out = self._model.transform(out)
        return (out.with_column("scored_labels", out["prediction"])
                   .drop(self._featurizer.output_col))


def _stage_from_reference(ref, cls, **params):
    """A port stage of class `cls` with the reference stage's set Params
    (those `cls` has) and its `_get_state()`, copied."""
    carried = {name: ref.get(name) for name in cls.params()
               if ref.has_param(name) and ref.is_set(name)}
    m = cls(**{**carried, **params})
    m._set_state({k: (v if isinstance(v, str) else np.array(v))
                  for k, v in ref._get_state().items()})
    return m


def _inner_from_reference(ref_model, **params):
    """The port's counterpart of a fitted reference inner model."""
    name = type(ref_model).__name__
    if name in ("LogisticRegressionModel", "LinearRegressionModel"):
        from ..models.linear import linear_from_reference
        return linear_from_reference(ref_model, **params)
    from ..models.gbdt import estimators as gbdt
    cls = getattr(gbdt, name, None)
    if cls is None:
        raise NotImplementedError(
            f"trained_from_reference carries linear and GBDT inner models; "
            f"{name} has no converter")
    return _stage_from_reference(ref_model, cls, **params)


def trained_from_reference(ref_model, **params):
    """A fitted reference `TrainedClassifierModel`/`TrainedRegressorModel`
    as the port's: the featurizer's plans, levels and fills, the label
    indexer's levels, and the inner model (`params`, e.g. `device`, go to
    the inner model)."""
    name = type(ref_model).__name__
    cls = {"TrainedClassifierModel": TrainedClassifierModel,
           "TrainedRegressorModel": TrainedRegressorModel}[name]
    m = cls(label_col=ref_model.label_col)
    m._featurizer = _stage_from_reference(ref_model._featurizer,
                                          FeaturizeModel)
    m._model = _inner_from_reference(ref_model._model, **params)
    label = getattr(ref_model, "_label_model", None)
    if label is not None:
        m._label_model = _stage_from_reference(label, ValueIndexerModel)
    return m
