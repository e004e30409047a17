"""GBDT pipeline stages: the LightGBMClassifier/Regressor/Ranker
equivalents.

Port of `mmlspark_tpu/models/gbdt/estimators.py`:
`GBDTClassifier(...).fit(table).transform(table)`, likewise
`GBDTRegressor` and `GBDTRanker` (lambdarank over a group column). Param
names are the reference's, so a pipeline can switch packages; the stages
are `PipelineStage`s, and a fitted model saves and loads with its booster
(`core/serialize.py`). Native categorical splits come from
`categorical_slot_indexes` and from `categorical_slot_names`, resolved
through the features column's `feature_names` metadata.
`checkpoint_dir` saves a step checkpoint (`utils.checkpoint`, the
reference's format) every `checkpoint_interval` iterations, in the
background with `checkpoint_async`, and a fit that finds one resumes from
its newest readable step, bit for bit as the uninterrupted fit would have
gone on; `num_batches` trains on sequential row batches, each continuing
the last one's booster. `num_tasks > 1`, or `num_tasks=0` with more than
one card, trains over a mesh of that many positions
(`distributed.fit_booster_distributed`), data_parallel or
voting_parallel (`parallelism`, `top_k`). The models add the
reference's `leaf_prediction_col` and `features_shap_col` columns and its
`set_best_iteration`, `feature_importances` and `save_native_model`;
`load_native_model` reads either package's native file.
`num_ingest_workers` (with `ingest_mode`, `ingest_chunk_rows` and
`ingest_prefetch`) builds the bin matrix with the data plane's parallel
ingest (`data.stage_binned`), and `out_of_core` with `max_resident_bytes`
stages it out of core (`data.ChunkStager`), its spill cache at
`checkpoint_dir/oocore_bins.npy` and its cursor in the checkpoint payload
(`oocore_cursor`). `quality_profile` (True by default, as in the
reference) freezes a fit-time reference profile of the training rows,
label and predictions onto the fitted model (`model.quality_profile`,
a `telemetry.quality.DatasetProfile` state). One param is the port's own:
`device` (None = the card).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Optional

import numpy as np
import torch

from ...core import (Estimator, HasFeaturesCol, HasLabelCol,
                     HasPredictionCol, HasProbabilitiesCol, HasWeightCol,
                     Model, Param, Table, in_range, one_of)
from ...data import IngestOptions, OocoreOptions
from ...device import resolve_device
from ...reliability import names as tnames
from ...reliability.metrics import reliability_metrics
from ...reliability.supervisor import AsyncCheckpointWriter
from ...utils.checkpoint import CheckpointManager
from .boosting import BoostParams, fit_booster
from .booster import Booster
from .distributed import default_mesh, fit_booster_distributed


def _host(col, dtype) -> np.ndarray:
    if isinstance(col, torch.Tensor):
        col = col.detach().cpu().numpy()
    return np.asarray(col, dtype=dtype)


def _device_count(device) -> int:
    """Devices a fit with num_tasks=0 would shard over: one for the CPU,
    every visible card for CUDA."""
    return (torch.cuda.device_count()
            if resolve_device(device).type == "cuda" else 1)


class _GBDTParams(HasFeaturesCol, HasLabelCol, HasWeightCol,
                  HasPredictionCol):
    boosting = Param("boosting", "gbdt|rf|dart|goss", "gbdt",
                     validator=one_of("gbdt", "rf", "dart", "goss"))
    num_iterations = Param("num_iterations", "number of boosting rounds",
                           100, validator=in_range(1))
    learning_rate = Param("learning_rate", "shrinkage rate", 0.1)
    num_leaves = Param("num_leaves", "max leaves per tree", 31,
                       validator=in_range(2))
    max_depth = Param("max_depth", "max tree depth (levels)", 5,
                      validator=in_range(1, 12))
    max_bin = Param("max_bin", "max feature bins", 255,
                    validator=in_range(2, 255))
    lambda_l1 = Param("lambda_l1", "L1 regularization", 0.0)
    lambda_l2 = Param("lambda_l2", "L2 regularization", 0.0)
    min_gain_to_split = Param("min_gain_to_split", "min split gain", 0.0)
    min_data_in_leaf = Param("min_data_in_leaf", "min rows per leaf", 20)
    min_sum_hessian_in_leaf = Param("min_sum_hessian_in_leaf",
                                    "min hessian mass per leaf", 1e-3)
    feature_fraction = Param("feature_fraction", "feature subsample per tree",
                             1.0, validator=in_range(0.0, 1.0))
    bagging_fraction = Param("bagging_fraction", "row subsample", 1.0,
                             validator=in_range(0.0, 1.0))
    bagging_freq = Param("bagging_freq", "bag every k iterations (0=off)", 0)
    top_rate = Param("top_rate", "GOSS large-gradient keep rate", 0.2)
    other_rate = Param("other_rate", "GOSS small-gradient sample rate", 0.1)
    drop_rate = Param("drop_rate", "DART tree drop rate", 0.1)
    max_drop = Param("max_drop", "DART max dropped trees per iteration", 50)
    skip_drop = Param("skip_drop", "DART probability of skipping drop", 0.5)
    xgboost_dart_mode = Param("xgboost_dart_mode",
                              "use xgboost-style dart weights", False)
    seed = Param("seed", "random seed", 0)
    early_stopping_round = Param(
        "early_stopping_round",
        "stop after k rounds w/o val improvement (0=off)", 0)
    metric = Param("metric", "eval metric for early stopping", None)
    validation_indicator_col = Param(
        "validation_indicator_col", "bool column marking validation rows",
        None)
    init_score_col = Param("init_score_col", "per-row initial margin column",
                           None)
    boost_from_average = Param("boost_from_average",
                               "init margin at label mean", True)
    parallelism = Param("parallelism", "data_parallel|voting_parallel",
                        "data_parallel",
                        validator=one_of("data_parallel", "voting_parallel"))
    top_k = Param("top_k", "voting_parallel: features voted per worker", 20)
    use_barrier_execution_mode = Param(
        "use_barrier_execution_mode", "gang-schedule workers (kept for "
        "parity)", False)
    num_batches = Param("num_batches",
                        "split training into sequential batches", 0)
    num_tasks = Param("num_tasks", "override worker count (0=all devices)", 0)
    sigmoid = Param("sigmoid", "sigmoid scale for binary objective", 1.0)
    verbosity = Param("verbosity", "log level", -1)
    categorical_slot_indexes = Param(
        "categorical_slot_indexes", "feature slots to treat as categorical",
        ())
    categorical_slot_names = Param(
        "categorical_slot_names", "feature names to treat as categorical",
        ())
    cat_smooth = Param("cat_smooth", "categorical sort-ratio smoothing", 10.0)
    cat_l2 = Param("cat_l2", "extra L2 for categorical splits", 10.0)
    max_cat_threshold = Param(
        "max_cat_threshold",
        "max categories on the smaller side of a categorical split", 32)
    leaf_prediction_col = Param("leaf_prediction_col",
                                "output column for per-tree leaf indices",
                                None)
    features_shap_col = Param("features_shap_col",
                              "output column for SHAP contributions", None)
    fobj = Param("fobj", "custom objective: (margin, y) -> (grad, hess)",
                 None, transient=True)
    num_ingest_workers = Param(
        "num_ingest_workers", "host ingest/binning workers (1=serial)", 1,
        validator=in_range(0))
    ingest_mode = Param("ingest_mode", "worker pool backend", "auto",
                        validator=one_of("auto", "process", "thread"))
    ingest_chunk_rows = Param("ingest_chunk_rows", "rows per ingest chunk",
                              0, validator=in_range(0))
    ingest_prefetch = Param("ingest_prefetch", "host->device prefetch depth",
                            2, validator=in_range(1))
    out_of_core = Param("out_of_core", "stream chunked binning", False)
    max_resident_bytes = Param("max_resident_bytes",
                               "out-of-core residency budget", 0,
                               validator=in_range(0))
    checkpoint_dir = Param("checkpoint_dir", "step-checkpoint directory",
                           None)
    checkpoint_interval = Param("checkpoint_interval",
                                "iterations between checkpoints", 25)
    checkpoint_async = Param("checkpoint_async",
                             "write periodic checkpoints in the background",
                             True)
    quality_profile = Param(
        "quality_profile",
        "freeze a reference feature/label/prediction distribution profile "
        "at fit time (telemetry.quality; bounded head sample)", True)
    device = Param("device", "torch device to train and score on "
                   "(None = the card)", None)

    def _attach_quality_profile(self, table: Table, model,
                                score_rows: int = 8192):
        """Freeze the fit-time reference profile onto the fitted model, as
        the reference does: quantile grids from a bounded head sample
        (`quality.MAX_REFERENCE_ROWS`) of the features, the label and the
        model's predictions on its first `score_rows` rows, the feature
        counts folded chunk by chunk through
        `data.pipeline.profile_columns`. The profile rides the model as a
        JSON-safe state dict. Profiling never fails a fit."""
        if not self.quality_profile:
            return model
        try:
            from ...data.pipeline import profile_columns
            from ...telemetry import quality as tquality
            cap = tquality.MAX_REFERENCE_ROWS
            x = _host(table[self.features_col][:cap], np.float32)
            y = _host(table[self.label_col][:cap], np.float64)
            feature_cols = tquality.matrix_columns(x)
            categorical = tuple(
                f"f{int(i)}" for i in (self.categorical_slot_indexes or ()))
            head = Table({self.features_col: x[:score_rows]})
            pred = np.asarray(
                model.transform(head)[self.prediction_col], np.float64)
            all_cols = dict(feature_cols)
            all_cols["label"] = y
            all_cols["prediction"] = pred
            prof = tquality.DatasetProfile.fit(
                all_cols, categorical=categorical, observe=False)
            profile_columns(prof, feature_cols)
            prof.observe("label", y)
            prof.observe("prediction", pred)
            model.quality_profile = prof.state()
        except Exception:  # noqa: BLE001 - observability never fails a fit
            pass
        return model

    def _attach_lineage(self, model):
        """Stamp the fit's provenance on the fitted model, as the reference
        does (`estimators.py:425`): the estimator class and uid, its
        non-transient Params, a digest of the frozen quality profile and,
        for a checkpointed fit, the checkpoint step. `telemetry.lineage.
        model_version` freezes it into the ModelVersion `/versions`
        reports; a configured `RunLedger` gets one line per fit. Lineage
        never fails a fit."""
        try:
            import hashlib
            params = {}
            for pname, p in type(self).params().items():
                if p.transient:
                    continue
                v = self.get_or_default(pname)
                try:
                    json.dumps(v)
                    params[pname] = v
                except (TypeError, ValueError):
                    params[pname] = repr(v)
            lineage = {"estimator": type(self).__name__, "uid": self.uid,
                       "params": params}
            prof = getattr(model, "quality_profile", None)
            if prof is not None:
                canon = json.dumps(prof, sort_keys=True, default=str)
                lineage["reference_profile"] = hashlib.sha256(
                    canon.encode()).hexdigest()[:12]
            if self.checkpoint_dir:
                step = CheckpointManager(self.checkpoint_dir).latest_step()
                if step is not None:
                    lineage["checkpoint_step"] = int(step)
            model.lineage = lineage
            from ...telemetry import lineage as tlineage
            ledger = tlineage.get_run_ledger()
            if ledger is not None:
                ledger.append(
                    tlineage.model_version(model, content=True).export())
        except Exception:  # noqa: BLE001 - observability never fails a fit
            pass
        return model

    def _use_mesh(self) -> bool:
        """The reference's rule: shard over num_tasks positions, or over
        every card when num_tasks is 0 and more than one is visible."""
        return self.num_tasks > 1 or (self.num_tasks == 0
                                      and _device_count(self.device) > 1)

    def _boost_params(self, objective: str, num_class: int = 1) -> BoostParams:
        return BoostParams(
            alpha=getattr(self, "alpha", BoostParams.alpha),
            tweedie_variance_power=getattr(
                self, "tweedie_variance_power",
                BoostParams.tweedie_variance_power),
            max_position=getattr(self, "max_position",
                                 BoostParams.max_position),
            fobj=self.fobj, objective=objective, boosting=self.boosting,
            num_iterations=self.num_iterations,
            learning_rate=self.learning_rate, num_leaves=self.num_leaves,
            max_depth=self.max_depth, max_bin=self.max_bin,
            lambda_l1=self.lambda_l1, lambda_l2=self.lambda_l2,
            min_gain_to_split=self.min_gain_to_split,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
            feature_fraction=self.feature_fraction,
            bagging_fraction=self.bagging_fraction,
            bagging_freq=self.bagging_freq, top_rate=self.top_rate,
            other_rate=self.other_rate, drop_rate=self.drop_rate,
            max_drop=self.max_drop, skip_drop=self.skip_drop,
            xgboost_dart_mode=self.xgboost_dart_mode, num_class=num_class,
            sigmoid=self.sigmoid, seed=self.seed,
            early_stopping_round=self.early_stopping_round,
            metric=self.metric, boost_from_average=self.boost_from_average,
            categorical_features=tuple(
                int(i) for i in (self.categorical_slot_indexes or ())),
            cat_smooth=self.cat_smooth, cat_l2=self.cat_l2,
            max_cat_threshold=self.max_cat_threshold,
            verbosity=self.verbosity)

    def _resolve_categoricals(self, table: Table, params: BoostParams):
        """Merge categorical_slot_names, resolved through the features
        column's `feature_names` metadata, into the slot-index set."""
        names = tuple(self.categorical_slot_names or ())
        if not names:
            return params
        feature_names = table.column_meta(self.features_col).get(
            "feature_names")
        if feature_names is None:
            raise ValueError(
                "categorical_slot_names given but the features column "
                f"{self.features_col!r} carries no feature_names metadata; "
                "use categorical_slot_indexes or attach names via "
                "Table.with_column_meta")
        name_to_idx = {nm: i for i, nm in enumerate(feature_names)}
        missing = [nm for nm in names if nm not in name_to_idx]
        if missing:
            raise KeyError(f"categorical_slot_names not in feature_names: "
                           f"{missing}")
        merged = tuple(sorted(set(params.categorical_features)
                              | {name_to_idx[nm] for nm in names}))
        return dataclasses.replace(params, categorical_features=merged)

    def _split_validation(self, table: Table):
        vcol = self.validation_indicator_col
        if vcol:
            if vcol not in table:
                raise KeyError(f"validation_indicator_col {vcol!r} not in "
                               f"table; have {table.columns}")
            mask = _host(table[vcol], bool)
            vx = _host(table[self.features_col], np.float32)[mask]
            vy = _host(table[self.label_col], np.float32)[mask]
            return table.filter(~mask), (vx, vy)
        return table, None

    def _resume(self, params: BoostParams):
        """The checkpoint directory's state, the reference's way: (None,
        the params of the remaining iterations, fit_booster's keywords,
        the background writer or None), or ((booster, base), None, None,
        None) when the newest readable step is final or no iteration
        remains."""
        mgr = CheckpointManager(self.checkpoint_dir)
        total, done = params.num_iterations, 0
        fit_kw = dict(init_booster=None, init_base=0.0, init_margin=None,
                      init_rng_key=None)
        if mgr.latest_step() is not None:
            # restore() falls back past a torn or corrupt newest step
            payload = mgr.restore()
            booster = Booster.load_model_string(str(payload["booster"]))
            base = float(payload.get("base", 0.0))
            if payload.get("final"):
                return (booster, base), None, None, None
            done = int(payload["iteration"])
            fit_kw = dict(init_booster=booster, init_base=base,
                          init_margin=payload.get("margin"),
                          init_rng_key=payload.get("rng_key"))
            denom = int(payload.get("rf_denom", total))
            if self.boosting == "rf" and denom != total:
                # restored rf leaves carry 1/denom weights; a forest grown
                # to a new total takes 1/total, and the saved margin, which
                # holds the old weights, no longer applies
                fit_kw.update(
                    init_booster=booster._replace(leaf_value=(
                        booster.leaf_value * (denom / total)).astype(
                            np.float32)),
                    init_margin=None, init_rng_key=None)
        if total <= done:
            return ((fit_kw["init_booster"], fit_kw["init_base"]), None,
                    None, None)
        writer = AsyncCheckpointWriter(mgr) if self.checkpoint_async \
            else None

        def ck_fn(it, booster, fit_base, final=False, margin=None,
                  rng_key=None):
            payload = {"booster": booster.save_model_string(),
                       "iteration": done + it, "base": float(fit_base),
                       "final": bool(final), "rf_denom": total}
            if self.out_of_core:
                # the staging cursor rides the payload for observability;
                # its source of truth for resume is the spill cache's
                # sidecar (data/oocore.py), which survives kills the
                # checkpoint cadence would miss
                payload["oocore_cursor"] = int(reliability_metrics.peek_gauge(
                    tnames.DATA_OOCORE_CURSOR) or 0)
            if margin is not None:
                payload["margin"] = np.asarray(margin, np.float32)
            if rng_key is not None:
                payload["rng_key"] = np.asarray(rng_key)
            if writer is None:
                mgr.save(done + it, payload, prune_newer=final)
            elif final:
                writer.write_sync(done + it, payload, prune_newer=True)
            else:
                writer.submit(done + it, payload)
        # rf averaging weights stay 1/total across the resume split
        params = dataclasses.replace(params, num_iterations=total - done,
                                     rf_total=total)
        return None, params, dict(
            fit_kw, checkpoint_fn=ck_fn, iter_offset=done,
            checkpoint_interval=self.checkpoint_interval), writer

    def _data_plane(self) -> dict:
        """fit_booster's `ingest` and `oocore` from the Params, as the
        reference's `_train` builds them."""
        ingest = oocore = None
        if self.num_ingest_workers != 1:
            ingest = IngestOptions(num_workers=self.num_ingest_workers,
                                   mode=self.ingest_mode,
                                   chunk_rows=self.ingest_chunk_rows,
                                   prefetch=self.ingest_prefetch)
        if self.out_of_core:
            cache = None
            if self.checkpoint_dir:
                cache = os.path.join(self.checkpoint_dir, "oocore_bins.npy")
            oocore = OocoreOptions(
                max_resident_bytes=self.max_resident_bytes,
                cache_path=cache, num_workers=self.num_ingest_workers,
                mode=("thread" if self.ingest_mode == "auto"
                      else self.ingest_mode),
                chunk_rows=self.ingest_chunk_rows,
                prefetch=self.ingest_prefetch)
        return dict(ingest=ingest, oocore=oocore)

    def _train(self, table: Table, objective: str, num_class: int = 1,
               group: Optional[np.ndarray] = None):
        train, valid = self._split_validation(table)
        x = _host(train[self.features_col], np.float32)
        y = _host(train[self.label_col], np.float32)
        w = (_host(train[self.weight_col], np.float32)
             if self.weight_col and self.weight_col in train else None)
        init = (_host(train[self.init_score_col], np.float32)
                if self.init_score_col and self.init_score_col in train
                else None)
        if group is not None and self.validation_indicator_col:
            # the training rows' ids (the reference passes the whole
            # table's: ROADMAP Queue 3 (n))
            group = group[~_host(table[self.validation_indicator_col], bool)]
        params = self._resolve_categoricals(
            table, self._boost_params(objective, num_class))
        fit = fit_booster
        if self._use_mesh():
            fit = functools.partial(
                fit_booster_distributed, parallelism=self.parallelism,
                top_k=self.top_k,
                mesh=default_mesh(self.num_tasks, self.device))
        fit = functools.partial(fit, **self._data_plane())
        n_batches = self.num_batches or 0
        if n_batches > 1:
            # batch continuation: each batch's trees fit the residuals of
            # the booster so far (checkpoints are single-batch, as in the
            # reference)
            booster, base, hist = None, 0.0, []
            for bi in np.array_split(np.arange(x.shape[0]), n_batches):
                if bi.size == 0:
                    continue
                booster, base, hist = fit(
                    x[bi], y[bi], params,
                    weights=None if w is None else w[bi],
                    init_scores=None if init is None else init[bi],
                    group=None if group is None else group[bi],
                    valid=valid, init_booster=booster, init_base=base,
                    device=self.device)
            return booster, base, hist
        fit_kw, writer = {}, None
        if self.checkpoint_dir:
            finished, params, fit_kw, writer = self._resume(params)
            if finished is not None:
                return (*finished, [])
        try:
            return fit(x, y, params, weights=w, init_scores=init,
                       valid=valid, group=group, device=self.device,
                       **fit_kw)
        finally:
            if writer is not None:
                writer.close()


class _GBDTModelBase(Model, HasFeaturesCol, HasPredictionCol):
    """Shared scoring surface."""
    device = Param("device", "torch device for bulk scoring (None = the "
                   "card)", None)
    leaf_prediction_col = Param("leaf_prediction_col",
                                "leaf index output col", None)
    features_shap_col = Param("features_shap_col", "SHAP output col", None)

    def __init__(self, booster: Optional[Booster] = None,
                 init_score: float = 0.0, **kw):
        super().__init__(**kw)
        self._booster = booster
        self._init_score = init_score

    def _get_state(self):
        d = self._booster.to_dict()
        d["init_score"] = np.float64(self._init_score)
        return d

    def _set_state(self, s):
        self._init_score = float(np.asarray(s.pop("init_score")))
        self._booster = Booster.from_dict(s)

    @property
    def booster(self) -> Booster:
        return self._booster

    def set_best_iteration(self, it: int):
        """Score with the first it + 1 iterations' trees (-1: all)."""
        self._booster = self._booster._replace(best_iteration=it)
        return self

    def feature_importances(self, importance_type="split"):
        return self._booster.feature_importances(importance_type)

    def save_native_model(self, path: str):
        """The reference's native file: the booster's JSON model string
        with the model's `init_score` beside its arrays."""
        payload = json.loads(self._booster.save_model_string())
        payload["init_score"] = self._init_score
        with open(path, "w") as f:
            f.write(json.dumps(payload))

    def _x(self, t: Table) -> np.ndarray:
        return _host(t[self.features_col], np.float32)

    def _raw(self, x: np.ndarray) -> np.ndarray:
        return self._booster.raw_score(x, self._init_score,
                                       device=self.device)

    def _serving_kernel(self, output_col: str):
        """Vectorized `(n, F) -> values` closure for the serving fast path
        (`io/plan.py`), on the booster's prebuilt host plan
        (`Booster.scoring_plan`): tree scoring with no Table and no
        per-request device dispatch, as in the reference. None when
        `output_col` is not one this model computes alone; the caller
        then takes the bucketed `transform` plan."""
        return None

    def _stamp_kernel(self, fn):
        """Annotate a kernel with the feature width the serving decode
        checks (a wrong-width request answers 400 at assembly)."""
        fn.expected_features = self._booster.n_features
        return fn

    def _maybe_extra_cols(self, t: Table, x: np.ndarray) -> Table:
        """The leaf-index and SHAP columns, where their params are set.
        The init score belongs to the model's expected value, so it is
        added to the bias column: each SHAP row sums to the raw
        prediction, as LightGBM's pred_contrib."""
        if self.leaf_prediction_col:
            t = t.with_column(self.leaf_prediction_col,
                              self._booster.predict_leaf(x,
                                                         device=self.device))
        if self.features_shap_col:
            contrib = self._booster.feature_contributions(
                x, device=self.device)
            contrib[:, -1] += self._init_score
            t = t.with_column(self.features_shap_col, contrib)
        return t


class GBDTClassifier(Estimator, _GBDTParams, HasProbabilitiesCol):
    """Binary/multiclass GBDT classifier."""
    objective = Param("objective", "binary|multiclass", "binary",
                      validator=one_of("binary", "multiclass"))
    num_class = Param("num_class", "number of classes (multiclass)", 2)
    raw_prediction_col = Param("raw_prediction_col",
                               "raw margin output column", "raw_prediction")

    def _fit(self, table: Table) -> "GBDTClassificationModel":
        y = _host(table[self.label_col], np.float64)
        multiclass = self.objective == "multiclass"
        n_classes = max(int(y.max()) + 1, self.num_class) if multiclass else 2
        booster, base, _ = self._train(
            table, self.objective, num_class=n_classes if multiclass else 1)
        return self._attach_lineage(self._attach_quality_profile(
            table, GBDTClassificationModel(
                booster=booster, init_score=base, n_classes=n_classes,
                features_col=self.features_col,
                prediction_col=self.prediction_col,
                probabilities_col=self.probabilities_col,
                raw_prediction_col=self.raw_prediction_col,
                sigmoid=self.sigmoid, device=self.device,
                leaf_prediction_col=self.leaf_prediction_col,
                features_shap_col=self.features_shap_col)))


class GBDTClassificationModel(_GBDTModelBase, HasProbabilitiesCol):
    raw_prediction_col = Param("raw_prediction_col",
                               "raw margin output column", "raw_prediction")
    n_classes = Param("n_classes", "number of classes", 2)
    sigmoid = Param("sigmoid", "sigmoid scale", 1.0)

    def _proba_from_raw(self, raw: np.ndarray) -> np.ndarray:
        if self._booster.objective == "multiclass":
            e = np.exp(raw - raw.max(axis=1, keepdims=True))
            return e / e.sum(axis=1, keepdims=True)
        p1 = 1.0 / (1.0 + np.exp(-self.sigmoid * raw[:, 0]))
        return np.stack([1 - p1, p1], axis=1)

    def _transform(self, t: Table) -> Table:
        x = self._x(t)
        raw = self._raw(x)
        proba = self._proba_from_raw(raw)
        pred = proba.argmax(axis=1).astype(np.float64)
        return self._maybe_extra_cols(
            t.with_column(self.raw_prediction_col, raw)
             .with_column(self.probabilities_col, proba)
             .with_column(self.prediction_col, pred), x)

    def _serving_kernel(self, output_col: str):
        multiclass = self._booster.objective == "multiclass"
        if output_col == self.prediction_col:
            plan = self._booster.scoring_plan(self._init_score)
            if multiclass:
                # softmax is monotonic: argmax(proba) == argmax(raw),
                # ties included (both take the first maximum)
                kern = lambda x: plan(x).argmax(axis=1).astype(np.float64)
            else:
                # argmax([1 - p1, p1]) == 1 iff p1 > 0.5 iff raw > 0
                kern = lambda x: (plan(x)[:, 0] > 0).astype(np.float64)
            return self._stamp_kernel(kern)
        if output_col == self.raw_prediction_col:
            return self._stamp_kernel(
                self._booster.scoring_plan(self._init_score))
        if output_col == self.probabilities_col:
            plan = self._booster.scoring_plan(self._init_score)
            return self._stamp_kernel(
                lambda x: self._proba_from_raw(plan(x)))
        return None


class GBDTRegressor(Estimator, _GBDTParams):
    """GBDT regressor; regression_l1/huber/quantile refit each leaf to a
    residual quantile."""
    objective = Param("objective", "regression objective", "regression",
                      validator=one_of("regression", "regression_l2",
                                       "regression_l1", "huber", "quantile",
                                       "poisson", "tweedie"))
    alpha = Param("alpha", "huber/quantile alpha", 0.9)
    tweedie_variance_power = Param("tweedie_variance_power", "tweedie rho",
                                   1.5)

    def _fit(self, table: Table) -> "GBDTRegressionModel":
        booster, base, _ = self._train(table, self.objective)
        return self._attach_lineage(self._attach_quality_profile(
            table, GBDTRegressionModel(
                booster=booster, init_score=base,
                features_col=self.features_col,
                prediction_col=self.prediction_col, device=self.device,
                leaf_prediction_col=self.leaf_prediction_col,
                features_shap_col=self.features_shap_col)))


class GBDTRegressionModel(_GBDTModelBase):
    def _link(self, raw: np.ndarray) -> np.ndarray:
        if self._booster.objective in ("poisson", "tweedie"):
            raw = np.exp(raw)
        return raw.astype(np.float64)

    def _transform(self, t: Table) -> Table:
        x = self._x(t)
        return self._maybe_extra_cols(
            t.with_column(self.prediction_col, self._link(self._raw(x)[:, 0])),
            x)

    def _serving_kernel(self, output_col: str):
        if output_col != self.prediction_col:
            return None
        plan = self._booster.scoring_plan(self._init_score)
        return self._stamp_kernel(lambda x: self._link(plan(x)[:, 0]))


class GBDTRanker(Estimator, _GBDTParams):
    """LambdaRank ranker with a group column (reference: LightGBMRanker)."""
    group_col = Param("group_col", "query/group id column", "group")
    max_position = Param("max_position", "NDCG truncation", 30)

    def _fit(self, table: Table) -> "GBDTRankerModel":
        _, group_ids = np.unique(_host(table[self.group_col], None),
                                 return_inverse=True)
        booster, base, _ = self._train(table, "lambdarank",
                                       group=group_ids.astype(np.int32))
        return self._attach_lineage(self._attach_quality_profile(
            table, GBDTRankerModel(
                booster=booster, init_score=base,
                features_col=self.features_col,
                prediction_col=self.prediction_col, device=self.device,
                leaf_prediction_col=self.leaf_prediction_col,
                features_shap_col=self.features_shap_col)))


class GBDTRankerModel(_GBDTModelBase):
    def _transform(self, t: Table) -> Table:
        x = self._x(t)
        return self._maybe_extra_cols(
            t.with_column(self.prediction_col,
                          self._raw(x)[:, 0].astype(np.float64)), x)

    def _serving_kernel(self, output_col: str):
        if output_col != self.prediction_col:
            return None
        plan = self._booster.scoring_plan(self._init_score)
        return self._stamp_kernel(
            lambda x: plan(x)[:, 0].astype(np.float64))


def load_native_model(path: str, model_cls=GBDTRegressionModel):
    """A native file of either package (`save_native_model`) as a model
    of `model_cls` (the reference's loadNativeModelFromFile)."""
    with open(path) as f:
        payload = json.loads(f.read())
    init_score = float(payload.pop("init_score", 0.0))
    return model_cls(booster=Booster.from_dict(payload),
                     init_score=init_score)
