"""Compiled inference plans: the serving fast path.

Port of the reference's `io/plan.py`. Everything around the model in a
served batch is host work the plan removes from the per-request path:

- `pipeline_fingerprint(stage)`: stable digest of a fitted stage's class,
  params and fitted-state shapes (`content=True`: its bytes). Plans are
  keyed on (content digest, shape bucket). The digest hashes the stage's
  module name, so the port's and the reference's digests of the same
  model differ by design; a state tensor on the card is hashed from a
  host copy, once per install.
- shape buckets (`stages.batching.shape_bucket`): request batches pad to
  power-of-two row counts, so a stage on the card sees a logarithmic
  number of batch shapes. A repeated bucket is a cache HIT
  (`serving.plan.hits` / `serving.plan.misses`, `ServingTransform.stats()`).
- GBDT models skip Table/transform: their `_serving_kernel` is
  `Booster.scoring_plan`, a prebuilt vectorized numpy descent on the host
  with no per-request device dispatch, as in the reference.
- Other models (`TransformerSentenceEncoder`, `DNNModel`, a `Pipeline`
  of such stages) score through `model.transform(Table(padded))` at the
  bucket on their device, on the partition's worker thread under
  `torch.no_grad()`; the result is copied to the host before encoding. A
  plan "compile" here is the build plus the first forward at the bucket
  (the thread's cuBLAS/cuDNN handles, the allocator's blocks), recorded
  as one `plan.compile` (`telemetry/perf.py`).
- one columnar decode per batch on the way in (per-row try/except: a
  malformed body answers 400 alone), preserialized reply framing on the
  way out.

A scoring error on the card is a server fault: it propagates to the
worker's replay and then a 502, never a rescore on the CPU. The
reference's `serving_plan_contract` (a JAX lowering contract) is ROADMAP
Queue 1 item 24 and raises NotImplementedError.
"""
from __future__ import annotations

import functools
import hashlib
import json
import math
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core import PipelineModel, Table
from ..core.params import Params
from ..reliability.metrics import reliability_metrics
from ..stages.batching import pad_rows_to_bucket, shape_bucket
from ..telemetry.spans import get_tracer
from ..telemetry import names as tnames
from ..telemetry import perf as tperf
from ..telemetry import quality as tquality
from ..utils import tracing
from ..utils.checkpoint import array_sha256
from .serving import Reply, _jsonable


# sparse-pair rows bucket their pairs-per-row (k) the way rows bucket:
# power of two, bounded, so every (rows, k) bucket is one shape
MAX_K_BUCKET = 1024


def __getattr__(name: str):
    if name == "serving_plan_contract":
        raise NotImplementedError(
            "io.plan.serving_plan_contract is the reference's JAX lowering "
            "contract, not ported yet (ROADMAP Queue 1 item 24)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _host_values(col) -> np.ndarray:
    """A scored column as a host array: a card tensor is copied back
    (`.cpu()` waits for the card), so JSON encoding never sees a CUDA
    tensor."""
    if hasattr(col, "detach"):
        col = col.detach().cpu().numpy()
    return np.asarray(col)


def _tensor_sha256(t: torch.Tensor) -> str:
    """`array_sha256` of a tensor (any dtype, bf16 included): dtype and
    shape qualify the digest of its contiguous bytes, read on the host."""
    h = hashlib.sha256()
    h.update(f"{t.dtype}{tuple(t.shape)}:".encode())
    h.update(t.detach().contiguous().reshape(-1).view(torch.uint8)
             .cpu().numpy().tobytes())
    return h.hexdigest()


def pipeline_fingerprint(stage, content: bool = False) -> str:
    """Stable hex digest of a (possibly nested) fitted stage.

    Two-digest contract (deployment observability):

    - `content=False` (default) — the STRUCTURAL digest: class,
      non-transient params, and fitted-state array shapes/dtypes. Cheap
      by design — array CONTENTS are not hashed. This is the lineage
      "same architecture?" axis.
    - `content=True` — the CONTENT digest: the same walk, but every
      fitted array's bytes are hashed (`utils.checkpoint.array_sha256`,
      dtype/shape-qualified). Two fits of the same architecture on
      different data digest differently — this is what
      `telemetry.lineage.model_version` builds ModelVersion identity
      (and the `X-Model-Version` reply stamp) from, and what the
      serving plan cache keys on, so a hot-swapped retrain never reuses
      the incumbent's compiled closures. Costs one pass over the fitted
      arrays; computed once per install, never per request.
    """
    h = hashlib.sha1()

    def feed(s):
        h.update(type(s).__module__.encode())
        h.update(type(s).__name__.encode())
        if isinstance(s, Params):
            for name, p in sorted(s.params().items()):
                if p.transient:
                    continue
                v = s.get_or_default(name)
                if isinstance(v, (list, tuple)) and any(
                        isinstance(e, Params) for e in v):
                    h.update(f"{name}:[{len(v)}]".encode())
                    for e in v:
                        feed(e)
                else:
                    h.update(f"{name}={v!r};".encode())
        state = getattr(s, "_get_state", lambda: {})()
        for k in sorted(state):
            v = state[k]
            if isinstance(v, np.ndarray):
                if content:
                    h.update(f"{k}:{array_sha256(v)};".encode())
                else:
                    h.update(f"{k}:{v.dtype}{v.shape};".encode())
            elif isinstance(v, torch.Tensor):
                if content:
                    h.update(f"{k}:{_tensor_sha256(v)};".encode())
                else:
                    h.update(f"{k}:{v.dtype}{tuple(v.shape)};".encode())
            else:
                h.update(f"{k}={v!r};".encode())
    feed(stage)
    return h.hexdigest()


def _decode_rows(bodies: Sequence[bytes], input_cols: Sequence[str]):
    """Per-row JSON decode with per-row failure isolation: returns
    (rows, replies) where rows[i] is the parsed dict or None, and
    replies[i] is a 400 `Reply` for the rows that failed — a malformed
    body answers immediately instead of poisoning its whole batch through
    the MAX_REPLAYS replay machinery."""
    rows: list = [None] * len(bodies)
    replies: list = [None] * len(bodies)
    for i, b in enumerate(bodies):
        try:
            row = json.loads(b)
            if not isinstance(row, dict):
                raise ValueError("body must be a JSON object")
            for c in input_cols:
                if c not in row:
                    raise KeyError(f"missing input column {c!r}")
        except (ValueError, KeyError, TypeError) as e:
            msg = e.args[0] if isinstance(e, KeyError) and e.args else str(e)
            replies[i] = Reply({"error": f"bad request: {msg}"}, status=400)
            continue
        rows[i] = row
    return rows, replies


class _ModelHandle:
    """One served model version: the model, its resolved row kernel, the
    content-qualified plan-cache fingerprint, and the ModelVersion id
    replies are stamped with. IMMUTABLE — `install_model` swaps the whole
    handle with a single attribute assignment (atomic under the GIL), so a
    worker that read the handle at batch start resolves its plan, runs
    its closures, and stamps its version all from ONE consistent model:
    in-flight requests are answered by the version that dequeued them,
    never a fingerprint/closure mix of old and new.

    The fingerprint is the CONTENT digest: plan closures capture the
    fitted model's arrays, so two fits of the same architecture must NOT
    share cache entries — a hot-swapped retrain would otherwise be scored
    by the incumbent's captured kernel while stamping the new version on
    the reply."""

    __slots__ = ("model", "kernel", "fingerprint", "version", "mv")

    def __init__(self, model, kernel, mv):
        self.model = model
        self.kernel = kernel
        self.mv = mv                      # the full ModelVersion record
        self.fingerprint = mv.content_digest
        self.version = mv.version


class ServingTransform:
    """The compiled `bodies -> replies` transform `serve_pipeline` mounts.

    Holds the per-(fingerprint, shape-bucket) plan cache. Worker threads
    share it: the dict lookup is lock-guarded but plans themselves are
    stateless closures, so the lock covers nanoseconds — partitions scale
    without a per-partition copy, and a stage on the card sees one stable
    batch shape per bucket.

    **Model-quality tap** (telemetry/quality.py): a served model carrying
    a `quality_profile` (the GBDT estimators freeze one at fit time)
    installs it as the process reference profile, and every served batch
    feeds the live sketches + the delayed-label join — head-sampled by
    request id, a no-op boolean test when no profile is installed.
    `wants_request_ids` tells the serving worker to pass each row's
    request id (== `X-Request-Id` == trace id), the label-join key.

    **Versioned handle + hot-swap** (telemetry/lineage.py): the served
    model lives in an immutable `_ModelHandle`; `install_model(model)`
    builds a fresh handle off-path and commits it atomically — zero
    dropped requests, old plans DRAIN out of the LRU (never
    invalidated), every reply stamped `X-Model-Version` with the version
    that scored it, and the version registry keeps per-version
    latency/error splits for `/versions` and the canary gauges."""

    wants_request_ids = True

    def __init__(self, model, input_cols: Sequence[str],
                 output_col: str = "prediction", max_bucket: int = 4096,
                 metrics=None, max_plans: int = 64, faults=None):
        self.input_cols = list(input_cols)
        self.output_col = output_col
        self.max_bucket = max_bucket
        self._metrics = metrics if metrics is not None else reliability_metrics
        self._faults = faults
        # bounded LRU: power-of-two bucketing keeps the steady-state key
        # count logarithmic, but a cache shared across hot-swapped model
        # versions or fed adversarial batch sizes must
        # not grow without bound. Eviction DRAINS, never invalidates:
        # plans are stateless (assemble, run) closures, so a worker
        # mid-batch on an evicted plan finishes on the object it holds —
        # the evicted key just rebuilds on next use (and the rebuild is
        # what `plan.recompiles` makes visible).
        self._plans: OrderedDict = OrderedDict()
        self.max_plans = max(int(max_plans), 1)
        self._lock = threading.Lock()
        # single-flight plan construction: key -> Event the builder sets
        # once the plan (or its failure) lands; concurrent missers wait
        # instead of compiling the same plan twice
        self._building: dict = {}
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        # reply framing serialized once: the write path appends only the
        # per-row value between these fragments
        self._prefix = ('{"%s": ' % output_col).encode()
        self._suffix = b"}"
        self._handle = self._make_handle(model)
        self._register_version(self._handle)
        self._install_profile(self._handle)

    # -- versioned handle ----------------------------------------------------
    @property
    def model(self):
        return self._handle.model

    @property
    def fingerprint(self) -> str:
        return self._handle.fingerprint

    @property
    def version(self) -> Optional[str]:
        return self._handle.version

    def _make_handle(self, model) -> _ModelHandle:
        # a single-stage PipelineModel serves through its one stage — the
        # wrapper adds nothing and would hide the stage's serving kernel
        stages = (model.get_or_default("stages")
                  if isinstance(model, PipelineModel) else None)
        model = stages[0] if stages is not None and len(stages) == 1 \
            else model
        # the row kernel consumes ONE features matrix — or, for sparse
        # models, the hashed `<f>_idx`/`<f>_val` column PAIR (the kernel
        # says so with a `sparse_pairs` marker); anything else goes
        # through the generic Table path
        kernel_of = getattr(model, "_serving_kernel", None)
        kernel = None
        if kernel_of is not None:
            if len(self.input_cols) == 1:
                kernel = kernel_of(self.output_col)
                if getattr(kernel, "sparse_pairs", False):
                    kernel = None   # pair kernel needs both columns
            elif (len(self.input_cols) == 2
                    and self.input_cols[0].endswith("_idx")
                    and self.input_cols[1].endswith("_val")):
                built = kernel_of(self.output_col)
                if getattr(built, "sparse_pairs", False):
                    kernel = built
        from ..telemetry import lineage as tlineage
        mv = tlineage.model_version(model)
        return _ModelHandle(model, kernel, mv)

    def _register_version(self, handle: _ModelHandle) -> dict:
        from ..telemetry import lineage as tlineage
        return tlineage.get_version_registry().install(
            handle.mv, metrics=self._metrics)

    @staticmethod
    def _install_profile(handle: _ModelHandle) -> None:
        # reference-profile install: the model's frozen fit-time profile
        # becomes the process quality reference (last served model
        # wins). Guarded: a
        # malformed profile loses quality observability, never serving.
        # `set_reference` also CLEARS the previous model's stale
        # quality.drift.* gauges, so a hot-swap never reports the old
        # version's drift as the new one's.
        profile = getattr(handle.model, "quality_profile", None)
        if profile:
            try:
                tquality.get_monitor().set_reference(profile)
            except Exception:  # noqa: BLE001
                pass

    def install_model(self, model) -> dict:
        """Zero-downtime hot-swap: build the new version's handle fully
        OFF the request path, then commit it with one atomic assignment.
        Workers mid-batch finish on the handle they already read (old
        plans drain via the LRU, never invalidated — `plan.recompiles`
        stays 0 for the incumbent's keys); the next batch they dequeue
        reads the new handle. A failure anywhere before the commit —
        including the seeded `serving.swap` chaos site — leaves the
        incumbent serving untouched (`serving.model.swap_errors`) and
        re-raises to the caller. Returns {"old": id|None, "new": id}."""
        try:
            new = self._make_handle(model)
            if self._faults is not None:
                self._faults.perturb("serving.swap")
            # registry install FIRST: freezing the incumbent's canary
            # baseline must read the OLD reference's live drift, so it
            # happens before the new profile swaps the quality reference
            swap = self._register_version(new)
        except Exception:
            self._metrics.inc(tnames.SERVING_MODEL_SWAP_ERRORS)
            raise
        self._install_profile(new)
        self._handle = new   # the commit point (atomic attribute swap)
        self._metrics.inc(tnames.SERVING_MODEL_SWAPS)
        get_tracer().event(tnames.SERVING_MODEL_SWAP_EVENT,
                           old=swap.get("old"), new=swap.get("new"),
                           plans=len(self._plans))
        return swap

    # -- plan construction ---------------------------------------------------
    # A plan is an (assemble, run) pair: `assemble` converts parsed rows to
    # arrays — everything that can fail there is CLIENT data (ragged row,
    # wrong type/width) and maps to a per-row 400; `run` executes the model
    # — failures there are server-side and propagate to the worker's
    # replay/502 machinery, never misreported as the client's fault.
    def _build_plan(self, bucket: int, handle: _ModelHandle):
        cols = self.input_cols
        if handle.kernel is not None and getattr(handle.kernel,
                                                 "sparse_pairs", False):
            # sparse hashed-pair fast path: ragged per-row (idx, val)
            # lists bucket on BOTH axes — rows to `bucket`, pairs-per-
            # row to a power-of-two k — then hit the kernel. Padded
            # pairs are (idx 0, val 0): zero score contribution, same
            # margin as the ragged row; one shape per (rows, k) bucket.
            kernel = handle.kernel
            icol, vcol = cols
            max_k = MAX_K_BUCKET

            def assemble(rows: list) -> dict:
                n = len(rows)
                widest = 1
                pairs = []
                for r in rows:
                    iv, vv = np.asarray(r[icol]), np.asarray(r[vcol])
                    if (iv.ndim != 1 or iv.shape != vv.shape
                            or iv.dtype == object or vv.dtype == object):
                        raise ValueError(
                            f"columns {icol!r}/{vcol!r} must be matching "
                            f"1-d (idx, val) pair lists")
                    if iv.shape[0] > max_k:
                        raise ValueError(
                            f"row carries {iv.shape[0]} pairs; the "
                            f"serving k bucket is bounded at {max_k}")
                    pairs.append((iv, vv))
                    widest = max(widest, iv.shape[0])
                kb = shape_bucket(widest, max_k)
                idx = np.zeros((n, kb), np.int32)
                val = np.zeros((n, kb), np.float32)
                for i, (iv, vv) in enumerate(pairs):
                    idx[i, :iv.shape[0]] = iv
                    val[i, :vv.shape[0]] = vv
                return {icol: idx, vcol: val}

            def run(data: dict) -> np.ndarray:
                idx, val = data[icol], data[vcol]
                n = idx.shape[0]
                idx = pad_rows_to_bucket(idx, bucket)
                val = pad_rows_to_bucket(val, bucket)
                return _host_values(kernel(idx, val))[:n]

            return assemble, run
        if handle.kernel is not None and getattr(handle.kernel,
                                                 "row_ids", False):
            # id-keyed fast path (the reference's SAR serving): each row is
            # ONE scalar integer id the kernel resolves against the
            # model's fitted tables. Rows pad to the bucket by repeating
            # the last id — a real id, so the kernel never sees synthetic
            # keys — and trim after. A non-integer or non-scalar id is
            # CLIENT data -> per-row 400 at assembly.
            kernel = handle.kernel
            col = cols[0]
            rows_metric = getattr(kernel, "rows_metric", None)
            metrics = self._metrics

            def assemble(rows: list) -> np.ndarray:
                ids = np.asarray([r[col] for r in rows])
                if ids.ndim != 1 or ids.dtype.kind not in "iu":
                    raise ValueError(
                        f"column {col!r} must hold scalar integer ids")
                return ids.astype(np.int64)

            def run(ids: np.ndarray) -> np.ndarray:
                n = ids.shape[0]
                out = _host_values(kernel(pad_rows_to_bucket(ids, bucket)))[:n]
                if rows_metric is not None:
                    metrics.inc(rows_metric, n)
                return out

            return assemble, run
        if handle.kernel is not None:
            kernel = handle.kernel
            col = cols[0]
            width = getattr(kernel, "expected_features", None)

            def assemble(rows: list) -> np.ndarray:
                x = np.asarray([r[col] for r in rows], dtype=np.float32)
                if x.ndim != 2 or (width is not None and x.shape[1] != width):
                    raise ValueError(
                        f"column {col!r} must be (n, {width}) numeric "
                        f"vectors, got shape {x.shape}")
                return x

            # vectorized host kernel: shape-agnostic numpy, no padding
            # needed — the bucket key only serves the hit accounting
            return assemble, kernel

        model, out_col = handle.model, self.output_col
        # the build's plan.compile record, taken by the plan's first run:
        # a stage on the card pays its first forward at this bucket there
        pending: list = []
        take = threading.Lock()

        def assemble(rows: list) -> dict:
            data = {}
            for c in cols:
                arr = np.asarray([r[c] for r in rows])
                if arr.dtype == object:
                    raise ValueError(
                        f"column {c!r} holds ragged or mixed-type rows")
                data[c] = arr
            return data

        def run(data: dict) -> np.ndarray:
            with take:
                record = pending.pop() if pending else None
            t0 = time.perf_counter()
            try:
                n = next(iter(data.values())).shape[0]
                padded = {c: pad_rows_to_bucket(a, bucket)
                          for c, a in data.items()}
                # grad mode is per thread: every worker's forward enters
                # no_grad itself
                with torch.no_grad():
                    out = model.transform(Table(padded))
                    return _host_values(out[out_col])[:n]
            finally:
                if record is not None:
                    record(time.perf_counter() - t0)

        run.record_first_run = pending.append
        return assemble, run

    def _plan_for(self, n_rows: int,
                  handle: Optional[_ModelHandle] = None) -> tuple:
        """Resolve (or build) the plan for this batch size, for THIS
        handle: keying and closure construction both read the handle the
        caller captured at batch start, so a hot-swap racing a build can
        never cache the new model's closures under the old fingerprint.
        (`handle=None` reads the currently served handle — the direct
        plan-inspection path tests use.)

        Miss-stampede contract: when N worker threads miss the same
        (fingerprint, bucket) concurrently, exactly ONE builds —
        `serving.plan.misses` counts real compiles, so it stays pinned at
        one per key no matter how many partitions race the cold cache.
        Waiters block on the builder's Event and count as hits (they got
        a plan without compiling). A builder that fails clears its Event
        so a waiter retries the build rather than caching the failure."""
        if handle is None:
            handle = self._handle
        bucket = shape_bucket(n_rows, self.max_bucket)
        key = (handle.fingerprint, bucket)
        while True:
            with self._lock:
                plan = self._plans.get(key)
                if plan is not None:
                    self._hits += 1
                    self._plans.move_to_end(key)   # LRU touch
                    wait_for = None
                else:
                    wait_for = self._building.get(key)
                    if wait_for is None:
                        # this thread is the builder
                        self._building[key] = threading.Event()
            if plan is not None:
                self._metrics.inc(tnames.SERVING_PLAN_HITS)
                return plan
            if wait_for is not None:
                wait_for.wait()   # builder is compiling; loop re-checks
                continue
            t0 = time.perf_counter()
            try:
                built = self._build_plan(bucket, handle)
            except BaseException:
                with self._lock:
                    self._building.pop(key).set()   # wake waiters to retry
                raise
            build_s = time.perf_counter() - t0
            evicted = 0
            with self._lock:
                self._plans[key] = built
                self._plans.move_to_end(key)
                while len(self._plans) > self.max_plans:
                    self._plans.popitem(last=False)   # drained, not closed
                    self._evictions += 1
                    evicted += 1
                self._misses += 1
                self._building.pop(key).set()
            self._metrics.inc(tnames.SERVING_PLAN_MISSES)
            if evicted:
                self._metrics.inc(tnames.SERVING_PLAN_EVICTIONS, evicted)
            # compile telemetry (telemetry/perf.py): plan.compile
            # span/histogram, per-(fingerprint, bucket) counts/seconds,
            # and the recompile detector — a key built AGAIN (eviction
            # pressure, or bucketing gone wrong) counts plan.recompiles,
            # which steady-state serving pins to zero. A Table plan's
            # record waits for its first run, whose forward is part of the
            # build on the card.
            record = functools.partial(self._record_build, handle, bucket,
                                       build_s)
            first_run = getattr(built[1], "record_first_run", None)
            if first_run is not None:
                first_run(record)
            else:
                record(0.0)
            return built

    def _record_build(self, handle: _ModelHandle, bucket: int,
                      build_s: float, first_run_s: float) -> None:
        kernel = handle.kernel
        tperf.record_plan_compile(
            handle.fingerprint, bucket, build_s + first_run_s,
            analysis={"rows_bucket": bucket,
                      "input_cols": len(self.input_cols),
                      "kind": ("sparse-kernel"
                               if getattr(kernel, "sparse_pairs", False)
                               else "id-kernel"
                               if getattr(kernel, "row_ids", False)
                               else "host-kernel" if kernel is not None
                               else "table-transform"),
                      "first_run_s": first_run_s},
            label=type(handle.model).__name__,
            registry=(None if self._metrics is reliability_metrics
                      else self._metrics))

    def stats(self) -> dict:
        fp = self._handle.fingerprint
        with self._lock:
            # stale = plans keyed by a superseded handle's fingerprint:
            # they DRAIN (LRU pressure from the new version's traffic
            # evicts them) — `stale_plans -> 0` is the hot-swap test's
            # drain assertion
            stale = sum(1 for (f, _b) in self._plans if f != fp)
            return {"hits": self._hits, "misses": self._misses,
                    "buckets": len(self._plans),
                    "evictions": self._evictions,
                    "capacity": self.max_plans,
                    "stale_plans": stale}

    # -- the transform -------------------------------------------------------
    def __call__(self, bodies: Sequence[bytes],
                 request_ids: Optional[Sequence[str]] = None) -> list:
        # ONE handle read per batch: plan keying, closure execution, and
        # the version stamp all come from it — a hot-swap committing
        # mid-batch changes none of this batch's behavior
        handle = self._handle
        rows, replies = _decode_rows(bodies, self.input_cols)
        if handle.version is not None:
            for i, r in enumerate(replies):
                if r is not None:
                    replies[i] = r._replace(version=handle.version)
        good_idx = [i for i, r in enumerate(rows) if r is not None]
        if not good_idx:
            return replies
        good_rows = [rows[i] for i in good_idx]
        assemble, run = self._plan_for(len(good_rows), handle)
        try:
            data = assemble(good_rows)
        except (ValueError, TypeError):
            # a parseable body with a BAD VALUE (ragged vector, wrong
            # type/width) breaks the columnar assembly — find the
            # offender(s) per row, 400 them, and run the model ONCE on
            # the survivors so batch-mates stay on the fast path
            survivors = []
            for i, row in zip(good_idx, good_rows):
                try:
                    survivors.append((i, row, assemble([row])))
                except (ValueError, TypeError) as e:
                    replies[i] = Reply({"error": f"bad request: {e}"},
                                       status=400, version=handle.version)
            if not survivors:
                return replies
            good_idx = [i for i, _, _ in survivors]
            try:
                data = assemble([row for _, row, _ in survivors])
            except (ValueError, TypeError):
                # rows valid ALONE but mutually incompatible (e.g. two
                # different vector widths, each plausible by itself):
                # score each row in its own batch — batch-mates stay
                # answered and nothing rides the replay machinery for
                # what is client-shaped data
                for i, _, single in survivors:
                    self._run_rows([i], single, run, replies, request_ids,
                                   handle)
                return replies
        self._run_rows(good_idx, data, run, replies, request_ids, handle)
        return replies

    def _run_rows(self, good_idx: list, data, run, replies: list,
                  request_ids: Optional[Sequence[str]] = None,
                  handle: Optional[_ModelHandle] = None) -> None:
        """Execute the plan and encode one reply per row. Exceptions from
        `run` are SERVER faults and propagate to the worker's replay/502
        machinery untouched (counted into the scoring version's split
        first — the canary's error-burn numerator). The span joins the
        ambient request trace the serving worker activated (no-op when
        the batch is unsampled)."""
        handle = handle if handle is not None else self._handle
        t0 = time.perf_counter()
        try:
            with get_tracer().span(tnames.SERVING_PLAN_RUN_SPAN,
                                   rows=len(good_idx)):
                # the span times the batch; the annotation names the
                # region on captured device profiles and notes its host
                # wall into the roofline ledger (telemetry/profiler.py)
                # — a triggered /debug/profile capture attributes
                # serving device time here
                with tracing.annotate(tnames.SERVING_PLAN_RUN_SPAN):
                    vals = _host_values(run(data))
        except BaseException:
            self._observe_version(handle, None, rows=len(good_idx),
                                  errors=len(good_idx))
            raise
        self._observe_version(handle, (time.perf_counter() - t0) * 1000.0,
                              rows=len(good_idx))
        # model-quality tap: live distribution sketches + the delayed-
        # label join (telemetry/quality.py). One boolean test when no
        # reference profile is installed; head-sampled by request id
        # otherwise. Never raises into the serving worker.
        tquality.observe_serving(
            data, vals,
            None if request_ids is None
            else [request_ids[i] for i in good_idx])
        prefix, suffix = self._prefix, self._suffix
        ver = handle.version
        if vals.ndim == 1 and vals.dtype.kind == "f":
            # scalar-float fast path: Python float repr IS shortest
            # round-trip JSON for finite values — skips json.dumps per
            # row; non-finite falls back to json.dumps (NaN/Infinity,
            # the same non-strict tokens the legacy path emitted)
            for i, v in zip(good_idx, vals.tolist()):
                enc = (repr(v) if math.isfinite(v)
                       else json.dumps(v)).encode()
                replies[i] = Reply(prefix + enc + suffix,
                                   content_type="application/json",
                                   version=ver)
        else:
            for i, v in zip(good_idx, vals):
                replies[i] = self._encode(v, ver)

    def _observe_version(self, handle: _ModelHandle, ms, rows: int = 1,
                         errors: int = 0) -> None:
        """Fold this batch into the scoring version's split registry —
        guarded: version accounting never fails a request."""
        if handle.version is None:
            return
        try:
            from ..telemetry import lineage as tlineage
            tlineage.get_version_registry().observe(
                handle.version, ms, rows=rows, errors=errors)
        except Exception:  # noqa: BLE001
            pass

    def _encode(self, v, version: Optional[str] = None) -> Reply:
        return Reply(
            self._prefix + json.dumps(_jsonable(v)).encode() + self._suffix,
            content_type="application/json", version=version)


def compile_serving_transform(model, input_cols: Sequence[str],
                              output_col: str = "prediction",
                              max_bucket: int = 4096,
                              max_plans: int = 64,
                              faults=None) -> ServingTransform:
    """Build the compiled serving transform for a fitted model/pipeline.
    See module docstring; `serve_pipeline` calls this.
    `max_plans` bounds the LRU plan cache (`serving.plan.evictions`);
    `faults` arms the `serving.swap` chaos site on `install_model`."""
    return ServingTransform(model, input_cols, output_col,
                            max_bucket=max_bucket, max_plans=max_plans,
                            faults=faults)
