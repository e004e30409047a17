"""Per-tenant feature utilities: `IdIndexer`, `StandardScalarScaler`,
`LinearScalarScaler` and their models.

A copy of the reference's `cyber/features.py` (role: the reference's
cyber/feature/indexers.py and scalers.py, pyspark wrappers around a
per-partition groupBy): per-tenant numpy passes over Table columns on
the host, on the port's `ops/levels.lookup_levels`. Ids are 1-based per
tenant, 0 kept for a value the fit never saw; every column equals the
reference's bit for bit. `IdIndexerModel` sorts a tenant's keys once,
not on every transform.
"""
from __future__ import annotations

import numpy as np

from ..core import Estimator, Model, Param, Table
from ..core.params import HasInputCol, HasOutputCol
from ..ops.levels import lookup_levels


class _HasTenant:
    tenant_col = Param("tenant_col", "tenant partition column", "tenant")


def _tenant_groups(t: Table, tenant_col: str):
    tenants = np.asarray(t[tenant_col])
    uniq, inv = np.unique(tenants, return_inverse=True)
    return uniq, inv


class IdIndexer(Estimator, _HasTenant, HasInputCol, HasOutputCol):
    """Per-tenant value -> dense 1-based index (reference:
    feature/indexers.py IdIndexer: ids are partitioned by tenant)."""

    def _fit(self, t: Table) -> "IdIndexerModel":
        uniq_t, inv = _tenant_groups(t, self.tenant_col)
        col = np.asarray(t[self.input_col])
        mapping = {}
        for k, ten in enumerate(uniq_t):
            vals = np.unique(col[inv == k])
            mapping[str(ten)] = {v: i + 1 for i, v in enumerate(vals)}
        m = IdIndexerModel(**{p: getattr(self, p) for p in
                              ("tenant_col", "input_col", "output_col")})
        m._mapping = mapping
        return m


class IdIndexerModel(Model, _HasTenant, HasInputCol, HasOutputCol):
    def __init__(self, **kw):
        super().__init__(**kw)
        self._mapping = {}
        # (the mapping they were sorted from, tenant -> sorted keys): the
        # reference sorts a tenant's keys on every transform; a served
        # model transforms a row at a time
        self._sorted = (None, {})

    def _sorted_keys(self, ten: str) -> np.ndarray:
        source, cache = self._sorted
        if source is not self._mapping:
            cache = {}
            self._sorted = (self._mapping, cache)
        keys = cache.get(ten)
        if keys is None:
            keys = cache[ten] = np.asarray(sorted(self._mapping[ten]))
        return keys

    def _get_state(self):
        # mapping as parallel arrays per tenant
        out = {"tenants": np.asarray(list(self._mapping), dtype=object)}
        for i, (ten, mp) in enumerate(self._mapping.items()):
            out[f"keys_{i}"] = np.asarray(list(mp), dtype=object)
        return out

    def _set_state(self, s):
        self._mapping = {}
        for i, ten in enumerate(np.asarray(s["tenants"])):
            keys = np.asarray(s[f"keys_{i}"])
            self._mapping[str(ten)] = {k: j + 1 for j, k in enumerate(keys)}

    def vocab_size(self, tenant) -> int:
        return len(self._mapping.get(str(tenant), {}))

    def _transform(self, t: Table) -> Table:
        tenants = np.asarray(t[self.tenant_col])
        col = np.asarray(t[self.input_col])
        out = np.zeros(len(t), np.int64)  # unseen -> 0 (reference: undefined)
        for ten in np.unique(tenants):
            mp = self._mapping.get(str(ten))
            if not mp:
                continue
            m = tenants == ten
            keys = self._sorted_keys(str(ten))
            idx, found = lookup_levels(keys, col[m])
            # mapping values are 1-based positions in insertion order; keys
            # were stored sorted, so position-in-sorted IS the id
            out[m] = np.where(found, idx + 1, 0)
        return t.with_column(self.output_col, out)


class StandardScalarScaler(Estimator, _HasTenant, HasInputCol, HasOutputCol):
    """Per-tenant standardization to target mean/std (reference:
    feature/scalers.py StandardScalarScaler)."""
    coefficient_factor = Param("coefficient_factor",
                               "multiplier on the standardized value", 1.0)

    def _fit(self, t: Table) -> "StandardScalarScalerModel":
        uniq_t, inv = _tenant_groups(t, self.tenant_col)
        col = np.asarray(t[self.input_col], np.float64)
        stats = {}
        for k, ten in enumerate(uniq_t):
            v = col[inv == k]
            stats[str(ten)] = (float(v.mean()), float(v.std() or 1.0))
        m = StandardScalarScalerModel(
            **{p: getattr(self, p) for p in
               ("tenant_col", "input_col", "output_col", "coefficient_factor")})
        m._stats = stats
        return m


class StandardScalarScalerModel(Model, _HasTenant, HasInputCol, HasOutputCol):
    coefficient_factor = Param("coefficient_factor", "multiplier", 1.0)

    def __init__(self, **kw):
        super().__init__(**kw)
        self._stats = {}

    def _get_state(self):
        return {"tenants": np.asarray(list(self._stats), dtype=object),
                "mean_std": np.asarray([list(v) for v in self._stats.values()],
                                       np.float64).reshape(-1, 2)}

    def _set_state(self, s):
        ms = np.asarray(s["mean_std"]).reshape(-1, 2)
        self._stats = {str(t): (float(m), float(sd))
                       for t, (m, sd) in zip(np.asarray(s["tenants"]), ms)}

    def _transform(self, t: Table) -> Table:
        tenants = np.asarray(t[self.tenant_col])
        col = np.asarray(t[self.input_col], np.float64)
        out = np.empty(len(t))
        for ten in np.unique(tenants):
            mean, std = self._stats.get(str(ten), (0.0, 1.0))
            m = tenants == ten
            out[m] = self.coefficient_factor * (col[m] - mean) / (std or 1.0)
        return t.with_column(self.output_col, out)


class LinearScalarScaler(Estimator, _HasTenant, HasInputCol, HasOutputCol):
    """Per-tenant linear map of [min, max] -> [min_required, max_required]
    (reference: feature/scalers.py LinearScalarScaler)."""
    min_required_value = Param("min_required_value", "output min", 0.0)
    max_required_value = Param("max_required_value", "output max", 1.0)

    def _fit(self, t: Table) -> "LinearScalarScalerModel":
        uniq_t, inv = _tenant_groups(t, self.tenant_col)
        col = np.asarray(t[self.input_col], np.float64)
        stats = {}
        for k, ten in enumerate(uniq_t):
            v = col[inv == k]
            lo, hi = float(v.min()), float(v.max())
            if hi == lo:
                a, b = 0.0, self.max_required_value
            else:
                a = (self.max_required_value - self.min_required_value) / (hi - lo)
                b = self.min_required_value - a * lo
            stats[str(ten)] = (a, b)
        m = LinearScalarScalerModel(
            **{p: getattr(self, p) for p in
               ("tenant_col", "input_col", "output_col")})
        m._stats = stats
        return m


class LinearScalarScalerModel(Model, _HasTenant, HasInputCol, HasOutputCol):
    def __init__(self, **kw):
        super().__init__(**kw)
        self._stats = {}

    def _get_state(self):
        return {"tenants": np.asarray(list(self._stats), dtype=object),
                "ab": np.asarray([list(v) for v in self._stats.values()],
                                 np.float64).reshape(-1, 2)}

    def _set_state(self, s):
        ab = np.asarray(s["ab"]).reshape(-1, 2)
        self._stats = {str(t): (float(a), float(b))
                       for t, (a, b) in zip(np.asarray(s["tenants"]), ab)}

    def _transform(self, t: Table) -> Table:
        tenants = np.asarray(t[self.tenant_col])
        col = np.asarray(t[self.input_col], np.float64)
        out = np.empty(len(t))
        for ten in np.unique(tenants):
            a, b = self._stats.get(str(ten), (1.0, 0.0))
            m = tenants == ten
            out[m] = a * col[m] + b
        return t.with_column(self.output_col, out)
