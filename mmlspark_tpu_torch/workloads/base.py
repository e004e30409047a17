"""Shared estimator-fleet integration for the workloads.

Port of the reference's `workloads/base.py`. A new workload should cost
an estimator and a plan builder, not a new serving or telemetry stack.
This module is the thin glue every `mmlspark_tpu_torch.workloads`
estimator rides to inherit the deployment stack: a fitted model leaves
`_fit` carrying

- ``model.quality_profile`` — a `telemetry.quality.DatasetProfile`
  state over workload-chosen reference columns (score distribution for
  the isolation forest, served top-k ids/scores for SAR), the drift
  reference `io.plan.ServingTransform` arms on install;
- ``model.lineage`` — estimator class, uid, JSON-safe params and the
  reference-profile digest;
- a content-addressed `telemetry.lineage.ModelVersion` journaled to the
  process `RunLedger`, so `X-Model-Version` stamps and `/versions`
  splits resolve for workload models exactly as they do for GBDT.

Everything here is best-effort: observability must never fail a fit.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np


def attach_workload_observability(est, model, profile_cols: dict,
                                  categorical=()) -> None:
    """Stamp `quality_profile` + `lineage` on a fitted workload model and
    journal its content version to the run ledger. `profile_cols` maps
    reference column names to arrays; names in `categorical` get top-k
    counters (e.g. recommended item ids) instead of quantile grids."""
    try:
        from ..telemetry import lineage as tlineage
        from ..telemetry import quality as tquality

        cols = {str(k): np.asarray(v).ravel()[:tquality.MAX_REFERENCE_ROWS]
                for k, v in profile_cols.items()}
        prof = tquality.DatasetProfile.fit(cols, categorical=tuple(categorical))
        model.quality_profile = prof.state()

        params = {}
        for name, p in type(est).params().items():
            if p.transient:
                continue
            v = est.get_or_default(name)
            try:
                json.dumps(v)
                params[name] = v
            except (TypeError, ValueError):
                params[name] = repr(v)
        canon = json.dumps(model.quality_profile, sort_keys=True, default=str)
        model.lineage = {
            "estimator": type(est).__name__,
            "uid": est.uid,
            "params": params,
            "reference_profile": hashlib.sha256(canon.encode()).hexdigest()[:12],
        }

        ledger = tlineage.get_run_ledger()
        if ledger is not None:
            ledger.append(tlineage.model_version(model, content=True).export())
    except Exception:
        # observability is advisory — a fit must never fail on it
        pass
