"""Carrying trained state across from the JAX reference package.

The reference's `Booster.to_dict()` is numpy arrays plus a `meta` JSON
string, and its `BinMapper` is numpy arrays; both convert field by field.
Because the model-string format is shared, `Booster.load_model_string`
in either package also reads the other's string directly.
"""
from __future__ import annotations

import numpy as np

from ...ops.binning import BinMapper
from .booster import Booster


def booster_from_reference(d: dict) -> Booster:
    """The reference `Booster.to_dict()` (or its JSON-decoded model
    string) -> the port's Booster. Categorical splits raise (not ported)."""
    return Booster.from_dict(d)


def bin_mapper_from_reference(upper_bounds, n_bins, max_bin,
                              categorical=None) -> BinMapper:
    """The reference BinMapper's fields -> the port's BinMapper."""
    return BinMapper(
        upper_bounds=np.asarray(upper_bounds, np.float32),
        n_bins=np.asarray(n_bins, np.int32), max_bin=int(max_bin),
        categorical=(None if categorical is None
                     else np.asarray(categorical, bool)))
