"""SAR on the serving fleet: the fit on the card, ONE sharded scoring
product.

Port of the reference's `workloads/sar_serving.py`:

- **Fit** (`SARServing`): the affinity A (U x I), the binary interaction
  matrix B, C = BᵀB, the support threshold and the jaccard/lift
  normalization all run on the model's device (None = the card), with
  the deterministic segment sums of `recommendation/sar.py`. Semantics
  (time decay, thresholds, normalizations) match the plain estimator.
- **Serving** (`SARServingModel.recommend_plan`): `A[users] @ S` with S
  row-sharded over the item axis of a data `Mesh`: each position
  contracts its item slice of the affinity columns against its S rows,
  and the partial (n, I) products are summed in position order (the
  reference's single `lax.psum`), followed by the reference's top-k per
  user row (`ops.topk.top_k`: the lower item id first among ties). The
  partials accumulate in float64 and the sum is rounded once, so every
  mesh gives the same answer. The plan's product function is cached per
  the reference's key (mesh, padded catalog, k); the reference's
  `AotCache` behind it is ROADMAP Queue 1 item 23. `_serving_kernel`
  marks itself `row_ids`, so `io/plan.py` buckets scalar user ids and
  answers `recommend?user=...` with `plan.recompiles` at 0.

Unknown user ids answer items=-1 / ratings=NaN (the cold-start 'nan'
convention of the plain model's `_transform`). The reference's
`sar_score_sharded_contract` (a JAX lowering contract) is ROADMAP Queue 1
item 24 and raises NotImplementedError.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import Param
from ..core.params import in_range
from ..device import resolve_device
from ..ops.topk import top_k
from ..parallel import DATA_AXIS, data_mesh
from ..recommendation.sar import SAR, SARModel, _fit_events, _scores64
from ..reliability.metrics import reliability_metrics
from ..telemetry import names as tnames
from .base import attach_workload_observability

# ratings below this are masked slots (padded catalog columns or
# remove_seen holes) — finite so JSON replies stay strict-parseable
_NEG = np.float32(-3.0e38)


def __getattr__(name: str):
    if name == "sar_score_sharded_contract":
        raise NotImplementedError(
            "workloads.sar_serving.sar_score_sharded_contract is the "
            "reference's JAX lowering contract, not ported yet (ROADMAP "
            "Queue 1 item 24)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _mesh_tag(mesh) -> tuple:
    return (tuple(sorted((str(k), int(v)) for k, v in mesh.shape.items())),
            tuple(str(d) for d in mesh.devices.reshape(-1)))


@functools.lru_cache(maxsize=64)
def _recommend_fn(mesh_tag: tuple, n_items_pad: int, k: int):
    """(A rows, S slices, penalty) -> (top-k items, top-k ratings) for a
    mesh of `mesh_tag`'s devices: position p contracts item columns
    [p * I/P, (p + 1) * I/P) of the affinity rows against its S rows on
    its device, the partials are summed in position order on the first
    position's device, rounded once to float32, and the penalty is
    added before the top-k."""
    devices = [torch.device(d) for d in mesh_tag[1]]
    width = n_items_pad // len(devices)

    def fn(a: torch.Tensor, s_slices: list, pen: torch.Tensor):
        total = None
        for p, (dev, s_p) in enumerate(zip(devices, s_slices)):
            part = _scores64(a[:, p * width:(p + 1) * width].to(dev), s_p)
            part = part.to(a.device)
            total = part if total is None else total + part
        vals, idx = top_k(total.to(torch.float32) + pen, k)
        return idx, vals

    return fn


class SARServing(SAR):
    """SAR fit on the card, producing the serving-integrated model. The
    plain Params plus the serving knobs (k, remove_seen) the compiled
    plan bakes in."""
    num_recommendations = Param(
        "num_recommendations", "k the compiled serving plan answers", 10,
        validator=in_range(1))
    remove_seen = Param(
        "remove_seen",
        "mask already-interacted items out of served recommendations",
        False)
    faults = Param(
        "faults", "reliability.faults.FaultInjector armed at the "
        "workloads.sar.refit site (chaos drills)", None, transient=True)

    def _fit(self, t) -> "SARServingModel":
        affinity, sim = _fit_events(self, t, "SARServing")
        if self.faults is not None:
            # chaos site: a refit that dies here must leave any serving
            # incumbent untouched (install only happens on a whole model)
            self.faults.perturb("workloads.sar.refit")

        m = SARServingModel(**{p: getattr(self, p) for p in (
            "user_col", "item_col", "rating_col", "similarity_function",
            "support_threshold", "num_recommendations", "remove_seen",
            "device")})
        m._affinity = affinity
        m._similarity = sim
        n_users, n_items = affinity.shape
        reliability_metrics.set_gauge(tnames.WORKLOADS_SAR_CATALOG_ITEMS,
                                      float(n_items))
        # drift reference: the ids and scores this model actually serves
        # for a head slice of users — top-k overlap shift is the canary
        out = m.recommend_plan()(np.arange(min(n_users, 512)))
        attach_workload_observability(
            self, m,
            {"recommended_item": out[:, 0, :].ravel(),
             "recommended_score": out[:, 1, :].ravel()},
            categorical=("recommended_item",))
        return m


class SARServingModel(SARModel):
    """The plain model plus the compiled serving surface: the sharded
    `recommend_plan` and the `row_ids` serving kernel that answers
    `recommend?user=...` through the io/plan.py bucketed fast path."""
    num_recommendations = Param(
        "num_recommendations", "k the compiled serving plan answers", 10,
        validator=in_range(1))
    remove_seen = Param(
        "remove_seen",
        "mask already-interacted items out of served recommendations",
        False)

    def _default_mesh(self):
        """The process's own data mesh: every visible card (None), or the
        model's device; never a mesh spanning processes, since each
        serving process answers alone."""
        if self.device is None:
            return data_mesh(span_processes=False)
        return data_mesh(devices=[resolve_device(self.device)],
                         span_processes=False)

    def recommend_plan(self, num_items=None, remove_seen=None, mesh=None):
        """Prebuilt user-ids -> (n, 2, k) closure: row r answers user
        ids[r] with out[r, 0] = top-k item ids and out[r, 1] = their
        scores. The catalog axis is padded to a multiple of the mesh's
        positions once at build and S's row slices placed on their
        positions; per call the affinity rows are gathered on the first
        position's device with the penalty (padded columns, and seen items
        when remove_seen), and the cached product function runs. `mesh`
        defaults to `_default_mesh()`; S's slices are held in float64
        (twice the similarity's bytes) for the plan's life. Unknown ids
        (outside the fitted user range) answer items=-1/ratings=NaN and
        count `workloads.sar.unknown_users`."""
        k = int(self.num_recommendations if num_items is None else num_items)
        rm = bool(self.remove_seen if remove_seen is None else remove_seen)
        mesh = self._default_mesh() if mesh is None else mesh
        positions = list(mesh.devices.reshape(-1))
        n_shards = int(mesh.shape[DATA_AXIS])
        if len(positions) != n_shards:
            raise ValueError(f"recommend_plan needs a 1-D data mesh of this "
                             f"process, got shape {mesh.shape}")
        dev = torch.device(positions[0])
        aff, sim = self._tables(dev)
        n_users, n_items = aff.shape
        k = min(k, n_items)
        pad = (-n_items) % n_shards
        i_pad = n_items + pad
        aff_p = torch.nn.functional.pad(aff, (0, pad)) if pad else aff
        sim_p = torch.nn.functional.pad(sim, (0, pad, 0, pad)) if pad \
            else sim
        width = i_pad // n_shards
        # each position's S rows, widened to float64 once per plan
        s_slices = [sim_p[p * width:(p + 1) * width].to(
            device=torch.device(d), dtype=torch.float64)
            for p, d in enumerate(positions)]
        col_pen = torch.zeros(i_pad, dtype=torch.float32, device=dev)
        col_pen[n_items:] = float(_NEG)
        fn = _recommend_fn(_mesh_tag(mesh), i_pad, k)

        def plan(ids: np.ndarray) -> np.ndarray:
            ids = np.asarray(ids, np.int64)
            known = (ids >= 0) & (ids < n_users)
            a = aff_p.index_select(0, torch.as_tensor(
                np.where(known, ids, 0), device=dev))    # (n, I_pad)
            pen = col_pen.expand(a.shape)
            if rm:
                pen = torch.where(a > 0, float(_NEG), pen)
            idx, vals = fn(a, s_slices, pen)
            out = np.empty((a.shape[0], 2, k), np.float64)
            out[:, 0, :] = idx.cpu().numpy()
            out[:, 1, :] = vals.cpu().numpy()
            out[~known, 0, :] = -1.0
            out[~known, 1, :] = np.nan
            n_unknown = int((~known).sum())
            if n_unknown:
                reliability_metrics.inc(tnames.WORKLOADS_SAR_UNKNOWN_USERS,
                                        n_unknown)
            return out

        return plan

    def _transform(self, t):
        """Users-only tables answer with the plain recommend path (the
        affinity rows scored per batch, then top_k) shaped like the
        compiled plan's (n, 2, k) output — the uncompiled
        `serve_pipeline(fast_path=False)` baseline. Ids that are not
        scalar integers raise ValueError, which that path answers 400, as
        the plan's assembly does; unknown ids answer items -1 and ratings
        NaN. Tables carrying the item column keep the plain (user, item)
        -> rating scoring."""
        if self.item_col in t:
            return super()._transform(t)
        ids = np.asarray(t[self.user_col])
        if ids.ndim != 1 or ids.dtype.kind not in "iu":
            raise ValueError(
                f"column {self.user_col!r} must hold scalar integer ids")
        k = min(int(self.num_recommendations),
                int(np.asarray(self._affinity).shape[1]))
        rec = self.recommend_for_user_subset(ids, k, bool(self.remove_seen))
        out = np.stack([np.asarray(rec["recommendations"], np.float64),
                        np.asarray(rec["ratings"], np.float64)], axis=1)
        return t.with_column("recommendations", out)

    def _serving_kernel(self, output_col: str):
        """Scalar-integer-id kernel for the io/plan.py fast path: marks
        itself `row_ids` so the plan buckets 1-d id batches (not feature
        matrices) and validates ids at assembly. Only the canonical
        'recommendations' output has a compiled plan."""
        if output_col != "recommendations":
            return None
        kernel = self.recommend_plan()
        kernel.row_ids = True
        kernel.rows_metric = tnames.WORKLOADS_SAR_RECOMMEND_ROWS
        return kernel
