"""CleanMissingData: NaN imputation per column (reference:
featurize/CleanMissingData.scala). A copy of
`mmlspark_tpu/featurize/clean_missing.py` (host numpy)."""
from __future__ import annotations

import numpy as np

from ..core import Estimator, Model, Param, Table, one_of


class CleanMissingData(Estimator):
    input_cols = Param("input_cols", "columns to impute", None)
    output_cols = Param("output_cols", "output columns (default: in place)", None)
    cleaning_mode = Param("cleaning_mode", "Mean|Median|Custom", "Mean",
                          validator=one_of("Mean", "Median", "Custom"))
    custom_value = Param("custom_value", "fill value for Custom mode", 0.0)

    def _fit(self, t: Table) -> "CleanMissingDataModel":
        cols = self.input_cols or [c for c in t.columns
                                   if np.issubdtype(t[c].dtype, np.floating)]
        fills = {}
        for c in cols:
            col = np.asarray(t[c], dtype=np.float64)
            ok = ~np.isnan(col)
            if self.cleaning_mode == "Mean":
                fills[c] = float(col[ok].mean()) if ok.any() else 0.0
            elif self.cleaning_mode == "Median":
                fills[c] = float(np.median(col[ok])) if ok.any() else 0.0
            else:
                fills[c] = float(self.custom_value)
        m = CleanMissingDataModel(input_cols=list(cols),
                                  output_cols=self.output_cols)
        m._fills = fills
        return m


class CleanMissingDataModel(Model):
    input_cols = Param("input_cols", "columns to impute", None)
    output_cols = Param("output_cols", "output columns", None)

    def __init__(self, **kw):
        super().__init__(**kw)
        self._fills = {}

    def _get_state(self):
        return {"fill_cols": np.asarray(list(self._fills.keys()), dtype=object),
                "fill_vals": np.asarray(list(self._fills.values()), np.float64)}

    def _set_state(self, s):
        self._fills = {str(k): float(v)
                       for k, v in zip(s["fill_cols"], s["fill_vals"])}

    def _transform(self, t: Table) -> Table:
        outs = self.output_cols or self.input_cols
        for cin, cout in zip(self.input_cols, outs):
            col = np.asarray(t[cin], dtype=np.float64)
            t = t.with_column(cout, np.where(np.isnan(col), self._fills[cin], col))
        return t
