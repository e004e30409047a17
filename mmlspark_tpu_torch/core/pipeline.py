"""Estimator/Transformer/Pipeline contracts over Table.

Port of `mmlspark_tpu/core/pipeline.py`:
- Transformer.transform(Table) -> Table;
- Estimator.fit(Table) -> Model (a fitted Transformer);
- Pipeline chains stages, PipelineModel chains fitted stages;
- every stage saves and loads through `core/serialize.py`: its class by
  qualified name, its explicitly set params and its `_get_state()`.

The reference also logs a usage event per fit and transform through its
telemetry; the port leaves that out until telemetry is ported (ROADMAP
Queue 1 item 23).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from .params import Param, Params
from .table import Table

# class name -> class, for generic load(); filled by
# PipelineStage.__init_subclass__
STAGE_REGISTRY: dict = {}


class PipelineStage(Params):
    """Base of every stage; registers subclasses for generic save/load."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        # the qualified key is authoritative (save_stage records it); the
        # bare name is a fallback and may be shadowed by a same-named class
        # of another module
        STAGE_REGISTRY[f"{cls.__module__}.{cls.__name__}"] = cls
        STAGE_REGISTRY[cls.__name__] = cls

    # -- persistence hooks ---------------------------------------------------
    def _get_state(self) -> dict:
        """Fitted state beyond the params: name -> ndarray | tensor |
        json-able value. Models override it."""
        return {}

    def _set_state(self, state: dict) -> None:
        pass

    def _prepare_save(self) -> None:
        """Called by serialize.save_stage before the params are read: a
        model holding fitted sub-stages in private attributes stashes them
        into Params here. Runs for nested stages too."""

    def _finish_load(self) -> None:
        """Called by serialize.load_stage after params and state are
        restored."""

    def save(self, path: str) -> None:
        from . import serialize
        serialize.save_stage(self, path)

    @classmethod
    def load(cls, path: str):
        from . import serialize
        return serialize.load_stage(path)


class Transformer(PipelineStage):
    def transform(self, table: Table) -> Table:
        return self._transform(table)

    def _transform(self, table: Table) -> Table:
        raise NotImplementedError

    def __call__(self, table: Table) -> Table:
        return self.transform(table)


class Model(Transformer):
    """A fitted Transformer."""


class Estimator(PipelineStage):
    def fit(self, table: Table, **fit_params) -> Model:
        if fit_params:
            return self.copy(fit_params)._fit(table)
        return self._fit(table)

    def _fit(self, table: Table) -> Model:
        raise NotImplementedError


class Evaluator(Params):
    """Scores a transformed Table; higher is better unless
    `is_larger_better` is False."""

    def evaluate(self, table: Table) -> float:
        raise NotImplementedError

    @property
    def is_larger_better(self) -> bool:
        return True


class Pipeline(Estimator):
    stages = Param("stages", "ordered list of pipeline stages", None)

    def __init__(self, stages: Optional[Sequence[PipelineStage]] = None,
                 **kwargs):
        super().__init__(**kwargs)
        if stages is not None:
            self.set(stages=list(stages))

    def _fit(self, table: Table) -> "PipelineModel":
        fitted: List[Transformer] = []
        current = table
        stages = self.get_or_default("stages") or []
        # transforms past the last Estimator feed nothing: skip them
        last_est = max((i for i, s in enumerate(stages)
                        if isinstance(s, Estimator)), default=-1)
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                model = stage.fit(current)
                fitted.append(model)
                if i < last_est:
                    current = model.transform(current)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if i < last_est:
                    current = stage.transform(current)
            else:
                raise TypeError(
                    f"stage {stage!r} is neither Estimator nor Transformer")
        return PipelineModel(stages=fitted)


class PipelineModel(Model):
    stages = Param("stages", "ordered list of fitted transformers", None)

    def __init__(self, stages: Optional[Sequence[Transformer]] = None,
                 **kwargs):
        super().__init__(**kwargs)
        if stages is not None:
            self.set(stages=list(stages))

    def _transform(self, table: Table) -> Table:
        current = table
        for stage in self.get_or_default("stages") or []:
            current = stage.transform(current)
        return current


def ml_transform(table: Table, *transformers: Transformer) -> Table:
    for t in transformers:
        table = t.transform(table)
    return table


def ml_fit(table: Table, estimator: Estimator) -> Model:
    return estimator.fit(table)
