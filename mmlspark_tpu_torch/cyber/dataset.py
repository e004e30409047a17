"""Synthetic access-log factory for CyberML experiments.

A copy of the reference's `cyber/dataset.py` (role: the reference's
cyber DataFactory, python/mmlspark/cyber/dataset.py): three departments
whose users access their own department's resources (training
distribution), plus generators for unseen SAME-department pairs (normal
test traffic) and CROSS-department pairs (anomalous test traffic).
AccessAnomaly should score the latter clearly higher. The draws are the
same `default_rng(seed)` stream in the same order, so a seed gives the
reference's tables.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core import Table


class DataFactory:
    """Clustered user->resource access generator.

    Departments are fully separate components; `single_component=True` adds
    one shared "free-for-all" resource every user touches so the access
    graph is connected (same trick as the reference)."""

    def __init__(self, num_hr_users: int = 7, num_hr_resources: int = 30,
                 num_fin_users: int = 5, num_fin_resources: int = 25,
                 num_eng_users: int = 10, num_eng_resources: int = 50,
                 single_component: bool = True, seed: int = 42):
        self.departments = {
            "hr": ([f"hr_user_{i}" for i in range(num_hr_users)],
                   [f"hr_res_{i}" for i in range(num_hr_resources)]),
            "fin": ([f"fin_user_{i}" for i in range(num_fin_users)],
                    [f"fin_res_{i}" for i in range(num_fin_resources)]),
            "eng": ([f"eng_user_{i}" for i in range(num_eng_users)],
                    [f"eng_res_{i}" for i in range(num_eng_resources)]),
        }
        self.join_resources = ["ffa"] if single_component else []
        self._rng = np.random.default_rng(seed)

    def _table(self, edges) -> Table:
        users = np.asarray([e[0] for e in edges], dtype=object)
        res = np.asarray([e[1] for e in edges], dtype=object)
        lik = np.asarray([e[2] for e in edges], dtype=np.float64)
        tenants = np.zeros(len(edges), dtype=np.int64)
        return Table({"tenant": tenants, "user": users, "res": res,
                      "likelihood": lik})

    def _edges_between(self, users: Sequence[str], resources: Sequence[str],
                       ratio: float, full_coverage: bool,
                       exclude: Optional[set] = None):
        """Random bipartite edges: each (user, resource) pair appears with
        probability `ratio`; `full_coverage` guarantees every user and every
        resource touches at least one edge; `exclude` skips known pairs."""
        edges, covered_u, covered_r = [], set(), set()
        exclude = exclude or set()
        for u in users:
            for r in resources:
                if (u, r) in exclude:
                    continue
                if self._rng.random() < ratio:
                    edges.append((u, r, float(self._rng.integers(500, 1001))))
                    covered_u.add(u)
                    covered_r.add(r)
        if full_coverage:
            for u in users:
                if u not in covered_u and resources:
                    r = resources[int(self._rng.integers(len(resources)))]
                    edges.append((u, r, float(self._rng.integers(500, 1001))))
            for r in resources:
                if r not in covered_r and users:
                    u = users[int(self._rng.integers(len(users)))]
                    edges.append((u, r, float(self._rng.integers(500, 1001))))
        return edges

    def _join_edges(self):
        out = []
        for users, _ in self.departments.values():
            out += self._edges_between(users, self.join_resources, 1.0, True)
        return out

    def create_clustered_training_data(self, ratio: float = 0.25) -> Table:
        """Intra-department access at the given density (+ join edges)."""
        edges = self._join_edges()
        for users, res in self.departments.values():
            edges += self._edges_between(users, res, ratio, True)
        return self._table(edges)

    def create_clustered_intra_test_data(self,
                                         train: Optional[Table] = None
                                         ) -> Table:
        """Sparse SAME-department pairs, excluding pairs seen in `train` —
        plausible unseen traffic, should score low."""
        seen = set()
        if train is not None:
            seen = set(zip(train["user"].tolist(), train["res"].tolist()))
        edges = self._join_edges()
        for dept, (users, res) in self.departments.items():
            ratio = {"hr": 0.025, "fin": 0.05, "eng": 0.035}[dept]
            edges += self._edges_between(users, res, ratio, False, seen)
        return self._table(edges)

    def create_clustered_inter_test_data(self) -> Table:
        """Sparse CROSS-department pairs — anomalous traffic, should score
        high."""
        edges = self._join_edges()
        names = list(self.departments)
        for a in names:
            for b in names:
                if a == b:
                    continue
                users = self.departments[a][0]
                res = self.departments[b][1]
                ratio = {"hr": 0.025, "fin": 0.05, "eng": 0.035}[a]
                edges += self._edges_between(users, res, ratio, False)
        return self._table(edges)
