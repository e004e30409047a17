"""ValueIndexer / IndexToValue: categorical <-> index codecs
(reference: featurize/ValueIndexer.scala, IndexToValue.scala; categorical
metadata semantics from core/schema/Categoricals.scala). A copy of
`mmlspark_tpu/featurize/value_indexer.py` (host numpy).
"""
from __future__ import annotations

import numpy as np

from ..core import (Estimator, Model, Param, Table, HasInputCol, HasOutputCol)
from ..ops.levels import lookup_levels


class ValueIndexer(Estimator, HasInputCol, HasOutputCol):
    """Fit the distinct levels of a column; transform values to int indices.
    Unseen values at transform time map to -1 (caller decides policy)."""

    def _fit(self, t: Table) -> "ValueIndexerModel":
        col = t[self.input_col]
        levels = np.unique(col[~_is_missing(col)])
        m = ValueIndexerModel(input_col=self.input_col,
                              output_col=self.output_col)
        m._levels = levels
        return m


class ValueIndexerModel(Model, HasInputCol, HasOutputCol):
    def __init__(self, **kw):
        super().__init__(**kw)
        self._levels = None

    def _get_state(self):
        return {"levels": np.asarray(self._levels)}

    def _set_state(self, s):
        self._levels = np.asarray(s["levels"])

    @property
    def levels(self):
        return self._levels

    def _transform(self, t: Table) -> Table:
        col = t[self.input_col]
        idx, found = lookup_levels(self._levels, col)
        out = np.where(found & ~_is_missing(col), idx, -1).astype(np.int64)
        # stamp categorical metadata so downstream stages can recover the
        # level names (core/schema/Categoricals.scala's CategoricalColumnInfo)
        return (t.with_column(self.output_col, out)
                 .with_column_meta(self.output_col,
                                   categorical_levels=self._levels.tolist()))


class IndexToValue(Model, HasInputCol, HasOutputCol):
    """Inverse mapping, given a fitted ValueIndexerModel's levels."""

    def __init__(self, levels=None, **kw):
        super().__init__(**kw)
        self._levels = None if levels is None else np.asarray(levels)

    def _get_state(self):
        return {"levels": np.asarray(self._levels)}

    def _set_state(self, s):
        self._levels = np.asarray(s["levels"])

    def _transform(self, t: Table) -> Table:
        idx = np.asarray(t[self.input_col]).astype(int)
        return t.with_column(self.output_col, self._levels[np.clip(idx, 0, None)])


def _is_missing(col: np.ndarray) -> np.ndarray:
    if np.issubdtype(col.dtype, np.floating):
        return np.isnan(col)
    if col.dtype == object:
        return np.asarray([v is None for v in col])
    return np.zeros(len(col), dtype=bool)
