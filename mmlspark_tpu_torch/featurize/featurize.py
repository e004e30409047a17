"""Featurize: automatic per-column featurization into one dense features matrix.

Reference: featurize/Featurize.scala:27-88 — per input column the fitted
pipeline applies: numeric -> impute(mean); categorical (string or flagged
int) -> ValueIndexer then one-hot (or index passthrough); high-cardinality
strings -> murmur hashing into `num_features` slots (2^18 default, 2^12 for
tree learners); vector columns pass through; all assembled by a fast
assembler (FastVectorAssembler analog = one np.concatenate).

A copy of `mmlspark_tpu/featurize/featurize.py` (host numpy).
"""
from __future__ import annotations

import numpy as np

from ..core import Estimator, Model, Param, Table, Transformer
from ..core.params import one_of
from ..ops.hashing import hash_strings
from ..ops.sparse import DENSE_AUTO_LIMIT
from .clean_missing import CleanMissingData
from .value_indexer import ValueIndexer

DEFAULT_NUM_FEATURES = 1 << 18       # Featurize.scala:27
DEFAULT_NUM_FEATURES_TREES = 1 << 12  # Featurize.scala:29


class Featurize(Estimator):
    input_cols = Param("input_cols", "columns to featurize (default: all but label)", None)
    output_col = Param("output_col", "assembled features column", "features")
    label_col = Param("label_col", "label column excluded from features", "label")
    one_hot_encode_categoricals = Param(
        "one_hot_encode_categoricals", "one-hot vs index for categoricals", True)
    num_features = Param("num_features",
                         "hash slots for high-cardinality strings (0=auto: "
                         "2^12 dense tree default; set 2^18 for the linear "
                         "default, which auto-switches to sparse output)", 0)
    max_onehot_cardinality = Param(
        "max_onehot_cardinality", "index/one-hot below, hash above", 64)
    impute_missing = Param("impute_missing", "mean-impute numeric NaN", True)
    dense_output = Param(
        "dense_output",
        "auto | True | False — False emits sparse pair columns "
        "<out>_idx/<out>_val instead of a dense matrix; 'auto' goes sparse "
        "when the assembled width exceeds 2^14 (each row's nnz is "
        "schema-static, so the pair shape is (n, n_slots))", "auto",
        validator=one_of("auto", True, False))

    def _fit(self, t: Table) -> "FeaturizeModel":
        cols = self.input_cols or [c for c in t.columns if c != self.label_col]
        plans = []  # (col, kind, aux)
        nf_hash = self.num_features or DEFAULT_NUM_FEATURES_TREES
        imputer_cols = []
        for c in cols:
            arr = t[c]
            if arr.ndim == 2:
                plans.append((c, "vector", arr.shape[1]))
            elif np.issubdtype(arr.dtype, np.number):
                plans.append((c, "numeric", None))
                if self.impute_missing and np.issubdtype(arr.dtype, np.floating):
                    imputer_cols.append(c)
            else:  # strings / objects
                uniq = np.unique(arr.astype(str))
                if uniq.size <= self.max_onehot_cardinality:
                    idx = ValueIndexer(input_col=c, output_col=f"__{c}_idx").fit(t)
                    kind = "onehot" if self.one_hot_encode_categoricals else "index"
                    plans.append((c, kind, idx))
                else:
                    plans.append((c, "hash", nf_hash))
        imputer = (CleanMissingData(input_cols=imputer_cols).fit(t)
                   if imputer_cols else None)
        m = FeaturizeModel(output_col=self.output_col,
                           dense_output=self.dense_output)
        m._plans, m._imputer = plans, imputer
        return m


class FeaturizeModel(Model):
    output_col = Param("output_col", "assembled features column", "features")
    dense_output = Param("dense_output", "auto | True | False", "auto",
                         validator=one_of("auto", True, False))

    def __init__(self, **kw):
        super().__init__(**kw)
        self._plans, self._imputer = [], None

    # -- layout ------------------------------------------------------------
    def _plan_widths(self):
        """Logical feature width per plan (vectors: length; numeric/index: 1;
        onehot: level count; hash: table size)."""
        out = []
        for c, kind, aux in self._plans:
            if kind == "vector":
                out.append(int(aux))
            elif kind in ("numeric", "index"):
                out.append(1)
            elif kind == "onehot":
                out.append(len(aux._levels))
            elif kind == "hash":
                out.append(int(aux))
        return out

    @property
    def num_output_features(self) -> int:
        """Total logical feature width of the assembled vector."""
        return sum(self._plan_widths())

    @property
    def _dense(self) -> bool:
        d = self.dense_output
        if d is True:
            return True
        if d is False:
            return False
        return self.num_output_features <= DENSE_AUTO_LIMIT

    # persistence: encode plans as parallel object arrays + nested stages
    def _get_state(self):
        state = {
            "plan_cols": np.asarray([p[0] for p in self._plans], dtype=object),
            "plan_kinds": np.asarray([p[1] for p in self._plans], dtype=object),
            "plan_dims": np.asarray(
                [p[2] if isinstance(p[2], int) else -1 for p in self._plans],
                np.int64),
        }
        for i, (c, kind, aux) in enumerate(self._plans):
            if kind in ("onehot", "index"):
                state[f"levels_{i}"] = np.asarray(aux._levels)
        if self._imputer is not None:
            st = self._imputer._get_state()
            state["imp_cols"] = st["fill_cols"]
            state["imp_vals"] = st["fill_vals"]
            state["imp_in"] = np.asarray(self._imputer.input_cols, dtype=object)
        return state

    def _set_state(self, s):
        from .value_indexer import ValueIndexerModel
        self._plans = []
        kinds = [str(k) for k in s["plan_kinds"]]
        for i, (c, kind, dim) in enumerate(zip(s["plan_cols"], kinds,
                                               s["plan_dims"])):
            c = str(c)
            if kind in ("onehot", "index"):
                vim = ValueIndexerModel(input_col=c, output_col=f"__{c}_idx")
                vim._levels = np.asarray(s[f"levels_{i}"])
                self._plans.append((c, kind, vim))
            elif kind in ("vector", "hash"):
                self._plans.append((c, kind, int(dim)))
            else:
                self._plans.append((c, kind, None))
        self._imputer = None
        if "imp_cols" in s:
            from .clean_missing import CleanMissingDataModel
            imp = CleanMissingDataModel(
                input_cols=[str(c) for c in np.asarray(s["imp_in"])])
            imp._set_state({"fill_cols": s["imp_cols"], "fill_vals": s["imp_vals"]})
            self._imputer = imp

    def _transform(self, t: Table) -> Table:
        if self._imputer is not None:
            t = self._imputer.transform(t)
        n = len(t)
        if self._dense:
            blocks = []
            for c, kind, aux in self._plans:
                arr = t[c]
                if kind == "vector":
                    blocks.append(np.asarray(arr, np.float32))
                elif kind == "numeric":
                    blocks.append(np.asarray(arr, np.float32)[:, None])
                elif kind == "index":
                    idx = np.asarray(aux.transform(t)[aux.output_col], np.float32)
                    blocks.append(idx[:, None])
                elif kind == "onehot":
                    idx = np.asarray(aux.transform(t)[aux.output_col])
                    k = len(aux._levels)
                    oh = np.zeros((len(idx), k), np.float32)
                    valid = idx >= 0
                    oh[np.nonzero(valid)[0], idx[valid]] = 1.0
                    blocks.append(oh)
                elif kind == "hash":
                    nf = aux
                    h = hash_strings(arr.astype(str), num_bits=int(np.log2(nf)))
                    hot = np.zeros((len(h), nf), np.float32)
                    hot[np.arange(len(h)), h] = 1.0
                    blocks.append(hot)
            feats = (np.concatenate(blocks, axis=1) if blocks
                     else np.zeros((n, 0), np.float32))
            return t.with_column(self.output_col, feats)

        # sparse pair output: one (idx, val) slot column group per plan,
        # offset into the concatenated logical feature space — O(n * slots)
        # memory regardless of num_features (2^18 hashing never materializes)
        idx_parts, val_parts = [], []
        offset = 0
        for (c, kind, aux), width in zip(self._plans, self._plan_widths()):
            arr = t[c]
            if kind == "vector":
                idx_parts.append(np.broadcast_to(
                    offset + np.arange(width, dtype=np.int32), (n, width)))
                val_parts.append(np.asarray(arr, np.float32))
            elif kind == "numeric":
                idx_parts.append(np.full((n, 1), offset, np.int32))
                val_parts.append(np.asarray(arr, np.float32)[:, None])
            elif kind == "index":
                ix = np.asarray(aux.transform(t)[aux.output_col], np.float32)
                idx_parts.append(np.full((n, 1), offset, np.int32))
                val_parts.append(ix[:, None])
            elif kind == "onehot":
                ix = np.asarray(aux.transform(t)[aux.output_col])
                valid = ix >= 0
                idx_parts.append((offset + np.clip(ix, 0, width - 1))
                                 .astype(np.int32)[:, None])
                val_parts.append(valid.astype(np.float32)[:, None])
            elif kind == "hash":
                h = hash_strings(arr.astype(str),
                                 num_bits=int(np.log2(aux)))
                idx_parts.append((offset + h).astype(np.int32)[:, None])
                val_parts.append(np.ones((n, 1), np.float32))
            offset += width
        o = self.output_col
        out = t.with_columns({
            f"{o}_idx": np.concatenate(idx_parts, axis=1) if idx_parts
            else np.zeros((n, 0), np.int32),
            f"{o}_val": np.concatenate(val_parts, axis=1) if val_parts
            else np.zeros((n, 0), np.float32)})
        # consumers (linear models, to_dense) read the logical feature-space
        # width from column metadata instead of guessing from observed ids
        return out.with_column_meta(f"{o}_idx",
                                    logical_width=self.num_output_features)


class CountSelector(Estimator):
    """Drop all-zero feature slots (reference: featurize/CountSelector.scala)."""
    input_col = Param("input_col", "features column", "features")
    output_col = Param("output_col", "output column", "features")

    def _fit(self, t: Table) -> "CountSelectorModel":
        x = np.asarray(t[self.input_col])
        keep = np.abs(x).sum(axis=0) > 0
        m = CountSelectorModel(input_col=self.input_col, output_col=self.output_col)
        m._keep = keep
        return m


class CountSelectorModel(Model):
    input_col = Param("input_col", "features column", "features")
    output_col = Param("output_col", "output column", "features")

    def __init__(self, **kw):
        super().__init__(**kw)
        self._keep = None

    def _get_state(self):
        return {"keep": np.asarray(self._keep)}

    def _set_state(self, s):
        self._keep = np.asarray(s["keep"])

    def _transform(self, t: Table) -> Table:
        x = np.asarray(t[self.input_col])
        return t.with_column(self.output_col, x[:, self._keep])


class DataConversion(Transformer):
    """Cast columns to a target dtype (reference: featurize/DataConversion.scala)."""
    cols = Param("cols", "columns to convert", None)
    convert_to = Param("convert_to", "numpy dtype name", "float32")

    def _transform(self, t: Table) -> Table:
        for c in self.cols or []:
            t = t.with_column(c, np.asarray(t[c]).astype(self.convert_to))
        return t
