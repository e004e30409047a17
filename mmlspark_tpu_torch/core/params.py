"""Param system: typed hyperparameters shared by every pipeline stage.

Port of `mmlspark_tpu/core/params.py`: plain Python descriptors collected
per class, the column-role mixins and the validators. Values that are
not JSON (arrays, tensors, nested stages, functions) are encoded by
`core/serialize.py`.
"""
from __future__ import annotations

import uuid
from typing import Any, Callable, Optional


class Param:
    """A single named, documented hyperparameter with optional validation."""

    __slots__ = ("name", "doc", "default", "validator", "owner", "transient")

    def __init__(self, name: str, doc: str = "", default: Any = None,
                 validator: Optional[Callable[[Any], bool]] = None,
                 transient: bool = False):
        self.name = name
        self.doc = doc
        self.default = default
        self.validator = validator
        self.owner = None  # set by Params.__init_subclass__
        # transient params (callables, live handles) are skipped by save();
        # a loaded stage reverts them to their default
        self.transient = transient

    def validate(self, value: Any) -> None:
        if self.validator is not None and value is not None:
            if not self.validator(value):
                raise ValueError(
                    f"Param {self.name}={value!r} failed validation")

    def __repr__(self):
        return f"Param({self.name!r}, default={self.default!r})"

    # descriptor protocol: stage.num_leaves reads the current value
    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.get_or_default(self.name)

    def __set__(self, obj, value):
        obj.set(**{self.name: value})


def in_range(lo=None, hi=None):
    def check(v):
        if lo is not None and v < lo:
            return False
        if hi is not None and v > hi:
            return False
        return True
    return check


def one_of(*options):
    return lambda v: v in options


positive = in_range(lo=0)


class Params:
    """Base for anything carrying Params; collects Param descriptors
    across the MRO. A stage's state is its uid plus its param map."""

    _param_registry: dict  # class-level: name -> Param

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        registry = {}
        for klass in reversed(cls.__mro__):
            for val in vars(klass).values():
                if isinstance(val, Param):
                    val.owner = val.owner or klass.__name__
                    registry[val.name] = val
        cls._param_registry = registry

    def __init__(self, **kwargs):
        self._paramMap: dict[str, Any] = {}
        self.uid = f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"
        self.set(**kwargs)

    @classmethod
    def params(cls) -> dict:
        return dict(cls._param_registry)

    def has_param(self, name: str) -> bool:
        return name in self._param_registry

    def is_set(self, name: str) -> bool:
        return name in self._paramMap

    def get(self, name: str) -> Any:
        if name not in self._param_registry:
            raise KeyError(f"{type(self).__name__} has no param {name!r}")
        return self._paramMap.get(name)

    def get_or_default(self, name: str) -> Any:
        if name in self._paramMap:
            return self._paramMap[name]
        if name not in self._param_registry:
            raise KeyError(f"{type(self).__name__} has no param {name!r}")
        return self._param_registry[name].default

    def set(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            if name not in self._param_registry:
                raise KeyError(
                    f"{type(self).__name__} has no param {name!r}; "
                    f"known: {sorted(self._param_registry)}")
            self._param_registry[name].validate(value)
            self._paramMap[name] = value
        return self

    def clear(self, name: str) -> "Params":
        self._paramMap.pop(name, None)
        return self

    def copy(self, extra: Optional[dict] = None) -> "Params":
        other = type(self).__new__(type(self))
        other.__dict__.update(
            {k: v for k, v in self.__dict__.items() if k != "_paramMap"})
        other._paramMap = dict(self._paramMap)
        if extra:
            other.set(**extra)
        return other

    def explain_params(self) -> str:
        lines = []
        for name, p in sorted(self._param_registry.items()):
            cur = self._paramMap.get(name, p.default)
            lines.append(f"{name}: {p.doc} (default: {p.default!r}, "
                         f"current: {cur!r})")
        return "\n".join(lines)

    def param_map(self) -> dict:
        """Effective values: explicit settings over defaults."""
        out = {n: p.default for n, p in self._param_registry.items()}
        out.update(self._paramMap)
        return out

    def __repr__(self):
        explicit = ", ".join(f"{k}={v!r}"
                             for k, v in sorted(self._paramMap.items()))
        return f"{type(self).__name__}({explicit})"


# shared column-role param mixins

class HasInputCol(Params):
    input_col = Param("input_col", "name of the input column", "input")


class HasOutputCol(Params):
    output_col = Param("output_col", "name of the output column", "output")


class HasInputCols(Params):
    input_cols = Param("input_cols", "names of the input columns", None)


class HasLabelCol(Params):
    label_col = Param("label_col", "name of the label column", "label")


class HasFeaturesCol(Params):
    features_col = Param("features_col", "name of the features column",
                         "features")


class HasWeightCol(Params):
    weight_col = Param("weight_col", "name of the sample-weight column", None)


class HasPredictionCol(Params):
    prediction_col = Param("prediction_col", "name of the prediction column",
                           "prediction")


class HasScoredLabelsCol(Params):
    scored_labels_col = Param(
        "scored_labels_col", "column holding predicted labels",
        "scored_labels")


class HasScoresCol(Params):
    scores_col = Param("scores_col", "column holding raw prediction scores",
                       "scores")


class HasProbabilitiesCol(Params):
    probabilities_col = Param(
        "probabilities_col", "column holding class probabilities",
        "probabilities")


class HasSeed(Params):
    seed = Param("seed", "random seed", 0)
