"""Table: the columnar collection every stage consumes and produces.

A trimmed copy of `mmlspark_tpu/core/table.py`: an ordered dict of named
columns with a partition count. Columns are numpy arrays or torch tensors
(device results may flow between stages without a host copy).
"""
from __future__ import annotations

import numpy as np
import torch


def _as_column(col):
    return col if isinstance(col, (np.ndarray, torch.Tensor)) \
        else np.asarray(col)


class Table:
    """Immutable ordered collection of named columns."""

    def __init__(self, data: dict, npartitions: int = 1):
        self._cols: dict = {}
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
        if npartitions < 1:
            raise ValueError("npartitions must be >= 1")
        self.npartitions = int(npartitions)

    @property
    def columns(self) -> list:
        return list(self._cols)

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __len__(self) -> int:
        return self._nrows

    def __getitem__(self, name: str):
        if name not in self._cols:
            raise KeyError(f"no column {name!r}; have {self.columns}")
        return self._cols[name]

    def with_column(self, name: str, col) -> "Table":
        arr = _as_column(col)
        if self._nrows and arr.shape[0] != self._nrows:
            raise ValueError(f"new column {name!r} has {arr.shape[0]} rows, "
                             f"table has {self._nrows}")
        return Table({**self._cols, name: arr}, self.npartitions)

    def filter(self, mask) -> "Table":
        """Rows where `mask` (numpy bool array) is True."""
        mask = np.asarray(mask, dtype=bool)
        return Table({n: c[torch.as_tensor(mask, device=c.device)]
                      if isinstance(c, torch.Tensor) else c[mask]
                      for n, c in self._cols.items()}, self.npartitions)

    def __repr__(self):
        cols = ", ".join(f"{n}:{c.dtype}{list(c.shape[1:]) or ''}"
                         for n, c in self._cols.items())
        return (f"Table[{self._nrows} rows x {len(self._cols)} cols, "
                f"p={self.npartitions}]({cols})")
