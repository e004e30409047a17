"""Estimator/Transformer contracts over Table.

A trimmed copy of `mmlspark_tpu/core/pipeline.py` holding what the GBDT
estimators need, without the reference's telemetry, persistence and
Pipeline layers: Transformer.transform(Table) -> Table and
Estimator.fit(Table) -> Model.
"""
from __future__ import annotations

from .params import Params
from .table import Table


class Transformer(Params):
    def transform(self, table: Table) -> Table:
        return self._transform(table)

    def _transform(self, table: Table) -> Table:
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer."""


class Estimator(Params):
    def fit(self, table: Table, **fit_params) -> Model:
        if fit_params:
            return self.copy(fit_params)._fit(table)
        return self._fit(table)

    def _fit(self, table: Table) -> Model:
        raise NotImplementedError
