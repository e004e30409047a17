"""Hyperparameter spaces (reference: automl/HyperparamBuilder.scala —
DiscreteHyperParam, RangeHyperParam, GridSpace, RandomSpace).

A copy of `mmlspark_tpu/automl/hyperparam.py`: the draws come from
numpy's `default_rng(seed)`, as the reference's do."""
from __future__ import annotations

import numpy as np


class DiscreteHyperParam:
    def __init__(self, values):
        # unwrap numpy scalars so the grid JSON-serializes
        self.values = [v.item() if hasattr(v, "item") else v for v in values]

    def sample(self, rng):
        return self.values[rng.integers(0, len(self.values))]

    def grid(self):
        return list(self.values)

    def _to_json(self):
        return {"values": self.values}

    @classmethod
    def _from_json(cls, d):
        return cls(d["values"])

    def __eq__(self, other):
        return type(other) is type(self) and other.values == self.values

    def __hash__(self):
        try:
            # hash(1) == hash(1.0) keeps this consistent with list __eq__
            return hash((type(self).__name__, tuple(self.values)))
        except TypeError:  # unhashable members
            return hash((type(self).__name__, len(self.values)))


class RangeHyperParam:
    def __init__(self, lo, hi, is_int=False, log=False):
        self.lo, self.hi, self.is_int, self.log = lo, hi, is_int, log

    def _to_json(self):
        return {"lo": self.lo, "hi": self.hi, "is_int": self.is_int,
                "log": self.log}

    @classmethod
    def _from_json(cls, d):
        return cls(d["lo"], d["hi"], d["is_int"], d["log"])

    def __eq__(self, other):
        return (type(other) is type(self)
                and (other.lo, other.hi, other.is_int, other.log)
                == (self.lo, self.hi, self.is_int, self.log))

    def __hash__(self):
        return hash((type(self).__name__, self.lo, self.hi, self.is_int,
                     self.log))

    def sample(self, rng):
        if self.log:
            v = float(np.exp(rng.uniform(np.log(self.lo), np.log(self.hi))))
        else:
            v = float(rng.uniform(self.lo, self.hi))
        return int(round(v)) if self.is_int else v

    def grid(self, n=5):
        if self.log:
            vs = np.exp(np.linspace(np.log(self.lo), np.log(self.hi), n))
        else:
            vs = np.linspace(self.lo, self.hi, n)
        return [int(round(v)) if self.is_int else float(v) for v in vs]


class HyperparamBuilder:
    def __init__(self):
        self._space = {}

    def add_hyperparam(self, name: str, param) -> "HyperparamBuilder":
        self._space[name] = param
        return self

    def build(self):
        return dict(self._space)


class GridSpace:
    """Cartesian product of all candidate values."""

    def __init__(self, space: dict):
        self.space = space

    def param_maps(self):
        import itertools
        names = list(self.space)
        grids = [p.grid() if hasattr(p, "grid") else list(p)
                 for p in self.space.values()]
        for combo in itertools.product(*grids):
            yield dict(zip(names, combo))


class RandomSpace:
    """Random draws from each hyperparam distribution."""

    def __init__(self, space: dict, seed: int = 0):
        self.space = space
        self.seed = seed

    def param_maps(self, n: int):
        rng = np.random.default_rng(self.seed)
        for _ in range(n):
            yield {name: p.sample(rng) for name, p in self.space.items()}
