"""Hashed sparse featurization with per-column namespaces.

Port of the reference's `models/vw/featurizer.py` (role: the reference's
vw/VowpalWabbitFeaturizer.scala:69-83 + vw/featurizer/*). Host numpy
over the port's own murmur3 (`ops/hashing.py`), so its `<out>_idx` /
`<out>_val` columns are bit-identical to the reference's:

- each input column is a NAMESPACE; a feature index is a murmur hash
  seeded by the namespace's hash (VowpalWabbitMurmurWithPrefix), masked
  to `num_bits` (vw/HasNumBits.scala);
- numeric: one slot per column, the value passed through;
  string/categorical: hash("name=value"), value 1; vector: one slot per
  element, the element's index in the feature name; `string_split_cols`:
  one unit feature per whitespace token.

The output is a pair of DENSE columns, `<out>_idx` (n, width) int32 and
`<out>_val` (n, width) float32, with a static per-schema width: what the
learner's segmented sum consumes without ragged shapes. Collisions within
a row are left to the learner, which adds them (sumCollisions=true,
vw/HasSumCollisions.scala).
"""
from __future__ import annotations

import numpy as np

from ...core import HasInputCols, HasOutputCol, Param, Table, Transformer
from ...ops.hashing import murmur3_32


def namespace_seed(name: str, hash_seed: int = 0) -> int:
    """VW hashes the namespace name to seed its features' hashes."""
    return murmur3_32(name.encode("utf-8"), hash_seed)


def feature_index(namespace: str, feature: str, num_bits: int,
                  hash_seed: int = 0) -> int:
    mask = (1 << num_bits) - 1
    return murmur3_32(feature.encode("utf-8"),
                      namespace_seed(namespace, hash_seed)) & mask


class VowpalWabbitFeaturizer(Transformer, HasInputCols, HasOutputCol):
    num_bits = Param("num_bits", "feature-space bits (mask = 2^b - 1)", 18)
    hash_seed = Param("hash_seed", "murmur seed", 0)
    string_split_cols = Param(
        "string_split_cols",
        "columns to tokenize on whitespace (StringSplit featurizer); each "
        "token becomes a hashed unit feature", None)

    def _transform(self, t: Table) -> Table:
        cols = self.input_cols or []
        split_cols = set(self.string_split_cols or [])
        n = len(t)
        mask = (1 << self.num_bits) - 1
        idx_parts, val_parts = [], []
        for name in cols:
            col = t[name]
            seed = namespace_seed(name, self.hash_seed)
            if name in split_cols:
                # ragged tokens -> static width = the most tokens of a row
                toks = [str(v).split() for v in col]
                width = max((len(tk) for tk in toks), default=1) or 1
                idx = np.zeros((n, width), np.int32)
                val = np.zeros((n, width), np.float32)
                for i, tk in enumerate(toks):
                    for j, token in enumerate(tk):
                        idx[i, j] = murmur3_32(token.encode(), seed) & mask
                        val[i, j] = 1.0
            elif col.dtype == object or col.dtype.kind in ("U", "S"):
                # categorical: hash "name=value", unit value; each distinct
                # key is hashed once
                keys = np.array([f"{name}={v}" for v in col], dtype=object)
                uniq, inverse = np.unique(keys, return_inverse=True)
                codes = np.fromiter(
                    (murmur3_32(k.encode(), seed) & mask for k in uniq),
                    np.int64, count=len(uniq))
                idx = codes[inverse.reshape(-1)].astype(np.int32) \
                    .reshape(n, 1)
                val = np.ones((n, 1), np.float32)
            elif col.ndim == 2:
                # vector namespace: one slot per element
                width = col.shape[1]
                base = np.fromiter(
                    (murmur3_32(str(j).encode(), seed) & mask
                     for j in range(width)), np.int32, count=width)
                idx = np.broadcast_to(base, (n, width)).copy()
                val = col.astype(np.float32)
            else:
                # numeric scalar: hash the column name, value passthrough
                h = murmur3_32(name.encode(), seed) & mask
                idx = np.full((n, 1), h, np.int32)
                val = np.asarray(col, np.float32).reshape(n, 1)
            idx_parts.append(idx)
            val_parts.append(val)
        idx = (np.concatenate(idx_parts, axis=1) if idx_parts
               else np.zeros((n, 0), np.int32))
        val = (np.concatenate(val_parts, axis=1) if val_parts
               else np.zeros((n, 0), np.float32))
        return (t.with_column(f"{self.output_col}_idx", idx)
                 .with_column(f"{self.output_col}_val", val))


class VowpalWabbitInteractions(Transformer, HasInputCols, HasOutputCol):
    """Quadratic feature crossing between two hashed namespaces, the
    client-side -q (reference: vw/VowpalWabbitInteractions.scala:96):
    crossed index = hash-combine of the pair, value = product."""
    num_bits = Param("num_bits", "feature-space bits", 18)

    MAGIC = 0x5BD1E995  # VW's FNV-style hash-combine multiplier

    def _transform(self, t: Table) -> Table:
        if not self.input_cols or len(self.input_cols) != 2:
            raise ValueError("VowpalWabbitInteractions needs exactly 2 "
                             "featurized output prefixes in input_cols")
        a, b = self.input_cols
        ia, va = np.asarray(t[f"{a}_idx"]), np.asarray(t[f"{a}_val"])
        ib, vb = np.asarray(t[f"{b}_idx"]), np.asarray(t[f"{b}_val"])
        mask = (1 << self.num_bits) - 1
        n, ka = ia.shape
        kb = ib.shape[1]
        # (n, ka*kb) crossed slots
        idx = ((ia[:, :, None].astype(np.int64) * self.MAGIC
                + ib[:, None, :]) & mask).astype(np.int32).reshape(n, ka * kb)
        val = (va[:, :, None] * vb[:, None, :]).reshape(n, ka * kb)
        return (t.with_column(f"{self.output_col}_idx", idx)
                 .with_column(f"{self.output_col}_val",
                              val.astype(np.float32)))
