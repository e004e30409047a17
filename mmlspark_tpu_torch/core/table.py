"""Table: the columnar collection every stage consumes and produces.

Port of `mmlspark_tpu/core/table.py`: an ordered dict of named columns
with a partition count and per-column metadata (categorical levels,
feature names). Columns are numpy arrays or torch tensors: device
results flow between stages without a host copy, and every method keeps
a tensor column a tensor on its own device. `materialize()` and
`to_pandas()` are the host copies.

`shuffle` and `split` draw their permutation with numpy from a seed, as
the reference does, so the same seed gives the same rows in either
package; a `torch.Generator` draws it with `torch.randperm` instead.
"""
from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch


def _as_column(col):
    return col if isinstance(col, (np.ndarray, torch.Tensor)) \
        else np.asarray(col)


def _rows(col, index):
    """`col[index]` for a numpy index array (or bool mask), with the index
    moved to a tensor column's device."""
    if isinstance(col, torch.Tensor):
        if not isinstance(index, torch.Tensor):
            index = torch.as_tensor(index)
        return col[index.to(col.device)]
    if isinstance(index, torch.Tensor):
        index = index.cpu().numpy()
    return col[index]


def _concat(cols: list):
    """Concatenate one column's pieces along rows: torch.cat when the
    first piece is a tensor (the rest follow it to its device), else
    numpy."""
    if isinstance(cols[0], torch.Tensor):
        dev = cols[0].device
        return torch.cat([torch.as_tensor(c).to(dev) for c in cols])
    return np.concatenate([c.cpu().numpy() if isinstance(c, torch.Tensor)
                           else c for c in cols])


def _to_host(col) -> np.ndarray:
    if isinstance(col, torch.Tensor):
        return col.detach().cpu().numpy()
    return np.asarray(col)


def _permutation(n: int, seed):
    """Row permutation: numpy's from an int seed (the reference's rows),
    `torch.randperm` from a torch.Generator."""
    if isinstance(seed, torch.Generator):
        return torch.randperm(n, generator=seed, device=seed.device).cpu()
    return np.random.default_rng(seed).permutation(n)


class Table:
    """Immutable ordered collection of named columns with a partition
    count and per-column metadata."""

    def __init__(self, data: dict, npartitions: int = 1, meta: dict = None):
        self._cols: dict = {}
        # per-column metadata (categorical levels, feature names), carried
        # through functional updates
        self._meta: dict = {k: dict(v) for k, v in (meta or {}).items()}
        nrows = None
        for name, col in data.items():
            arr = _as_column(col)
            if nrows is None:
                nrows = arr.shape[0] if arr.ndim else 0
            elif arr.shape[0] != nrows:
                raise ValueError(
                    f"column {name!r} has {arr.shape[0]} rows, "
                    f"expected {nrows}")
            self._cols[name] = arr
        self._nrows = nrows or 0
        # metadata only for columns that exist: drop/select prune it
        self._meta = {k: v for k, v in self._meta.items() if k in self._cols}
        if npartitions < 1:
            raise ValueError("npartitions must be >= 1")
        self.npartitions = int(npartitions)

    def _like(self, data: dict, npartitions: int = None) -> "Table":
        return Table(data, self.npartitions if npartitions is None
                     else npartitions, meta=self._meta)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_pandas(cls, df, npartitions: int = 1) -> "Table":
        return cls({name: df[name].to_numpy() for name in df.columns},
                   npartitions)

    def to_pandas(self):
        import pandas as pd
        out = {}
        for name, col in self._cols.items():
            col = _to_host(col)
            out[name] = list(col) if col.ndim > 1 else col
        return pd.DataFrame(out)

    # -- schema ---------------------------------------------------------------
    @property
    def columns(self) -> list:
        return list(self._cols)

    def schema(self) -> dict:
        return {n: (c.dtype, tuple(c.shape[1:])) for n, c in self._cols.items()}

    # -- per-column metadata ---------------------------------------------------
    def column_meta(self, name: str) -> dict:
        return dict(self._meta.get(name, {}))

    def with_column_meta(self, name: str, **entries) -> "Table":
        """Attach metadata entries to a column (categorical levels, the
        features column's `feature_names`)."""
        if name not in self._cols:
            raise KeyError(f"no column {name!r}; have {self.columns}")
        meta = {k: dict(v) for k, v in self._meta.items()}
        meta.setdefault(name, {}).update(entries)
        return Table(self._cols, self.npartitions, meta=meta)

    def categorical_levels(self, name: str):
        """Levels recorded for a categorical column, or None."""
        return self._meta.get(name, {}).get("categorical_levels")

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __len__(self) -> int:
        return self._nrows

    def __getitem__(self, name: str):
        if name not in self._cols:
            raise KeyError(f"no column {name!r}; have {self.columns}")
        return self._cols[name]

    def column(self, name: str):
        return self[name]

    # -- functional updates ----------------------------------------------------
    def with_column(self, name: str, col) -> "Table":
        arr = _as_column(col)
        if self._nrows and arr.shape[0] != self._nrows:
            raise ValueError(f"new column {name!r} has {arr.shape[0]} rows, "
                             f"table has {self._nrows}")
        # a replaced column's old metadata no longer describes it
        meta = ({k: v for k, v in self._meta.items() if k != name}
                if name in self._cols else self._meta)
        return Table({**self._cols, name: arr}, self.npartitions, meta=meta)

    def with_columns(self, cols: dict) -> "Table":
        out = self
        for k, v in cols.items():
            out = out.with_column(k, v)
        return out

    def select(self, names: Sequence[str]) -> "Table":
        return self._like({n: self[n] for n in names})

    def drop(self, *names: str) -> "Table":
        return self._like({n: c for n, c in self._cols.items()
                           if n not in names})

    def rename(self, mapping: dict) -> "Table":
        return Table({mapping.get(n, n): c for n, c in self._cols.items()},
                     self.npartitions,
                     meta={mapping.get(n, n): m
                           for n, m in self._meta.items()})

    def filter(self, mask) -> "Table":
        """Rows where `mask` (a bool numpy array or tensor) is True."""
        if not isinstance(mask, torch.Tensor):
            mask = np.asarray(mask)
        return self._like({n: _rows(c, mask) for n, c in self._cols.items()})

    def take(self, n: int) -> "Table":
        return self._like({k: c[:n] for k, c in self._cols.items()})

    def concat(self, other: "Table") -> "Table":
        if set(other.columns) != set(self.columns):
            raise ValueError("schema mismatch in concat")
        return self._like({n: _concat([self._cols[n], other._cols[n]])
                           for n in self.columns})

    @staticmethod
    def concat_all(tables: Sequence["Table"]) -> "Table":
        if not tables:
            raise ValueError("empty concat")
        first = tables[0]
        return first._like({n: _concat([t[n] for t in tables])
                            for n in first.columns})

    # -- partitioning ----------------------------------------------------------
    def repartition(self, npartitions: int) -> "Table":
        return self._like(self._cols, npartitions)

    def partition_bounds(self) -> list:
        """Row ranges per partition: contiguous row blocks."""
        splits = np.linspace(0, self._nrows, self.npartitions + 1).astype(int)
        return [(int(splits[i]), int(splits[i + 1]))
                for i in range(self.npartitions)]

    def partitions(self) -> Iterable["Table"]:
        for lo, hi in self.partition_bounds():
            yield self._like({n: c[lo:hi] for n, c in self._cols.items()}, 1)

    def partition(self, i: int) -> "Table":
        lo, hi = self.partition_bounds()[i]
        return self._like({n: c[lo:hi] for n, c in self._cols.items()}, 1)

    def map_partitions(self, fn: Callable[["Table"], "Table"]) -> "Table":
        """Host-side per-partition map (IO stages); numeric stages operate
        on whole columns."""
        parts = [fn(p) for p in self.partitions()]
        parts = [p for p in parts if p is not None and len(p.columns)]
        out = Table.concat_all(parts)
        return Table(out._cols, self.npartitions, meta=out._meta)

    def shuffle(self, seed=0) -> "Table":
        """Rows in a random order; `seed` is an int (numpy, the
        reference's rows) or a torch.Generator."""
        perm = _permutation(self._nrows, seed)
        return self._like({n: _rows(c, perm) for n, c in self._cols.items()})

    def split(self, fraction: float, seed=0):
        """Random (train, test) split; `seed` as in `shuffle`."""
        perm = _permutation(self._nrows, seed)
        k = int(round(self._nrows * fraction))
        a, b = perm[:k], perm[k:]
        return (self._like({n: _rows(c, a) for n, c in self._cols.items()}),
                self._like({n: _rows(c, b) for n, c in self._cols.items()}))

    def materialize(self) -> "Table":
        """Every column as a host numpy array: the explicit device sync."""
        return self._like({n: _to_host(c) for n, c in self._cols.items()})

    # -- misc --------------------------------------------------------------------
    def find_unused_column_name(self, prefix: str) -> str:
        if prefix not in self._cols:
            return prefix
        i = 1
        while f"{prefix}_{i}" in self._cols:
            i += 1
        return f"{prefix}_{i}"

    def __repr__(self):
        cols = ", ".join(f"{n}:{c.dtype}{list(c.shape[1:]) or ''}"
                         for n, c in self._cols.items())
        return (f"Table[{self._nrows} rows x {len(self._cols)} cols, "
                f"p={self.npartitions}]({cols})")
