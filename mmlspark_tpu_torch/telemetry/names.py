"""The metric, span, event and fault-site names the port records, in one
place.

The strings are the reference's (`mmlspark_tpu/telemetry/names.py`), so a
dashboard, a scrape merge or an alert reads either package: the
checkpoint path, the training supervisor and its goodput clock, the
multi-process layer, the data plane, the serving stack (ingress,
partition workers, the plan cache, hot-swap, the service registry), the
fleet workloads (isolation forest, SAR), its compile log, the
model-quality tap, the version registry's canary gauges and the tracer's
spans and events. `reliability/names.py` re-exports this module, so the
names its callers import there are these.

Dotted `subsystem.signal[.detail]`, lowercase; a patterned name carries a
`{placeholder}` that a helper below renders. A fault site keeps its
literal at its `fire`/`perturb` call ("serving.worker", "serving.ingress",
"serving.swap", "quality.label", "train.ckpt.write").
"""

# ------------------------------------------------------------------ counters
SERVING_SHED_REQUESTS = "serving.shed_requests"
SERVING_REQUEST_TOTAL = "serving.request.total"
SERVING_REQUEST_ERRORS = "serving.request.errors"
SERVING_WORKER_RESTARTS = "serving.worker_restarts"
SERVING_REPLAYED_EPOCHS = "serving.replayed_epochs"
SERVING_SIGNAL_DRAINS = "serving.signal_drains"
SERVING_PLAN_HITS = "serving.plan.hits"
SERVING_PLAN_MISSES = "serving.plan.misses"
SERVING_PLAN_EVICTIONS = "serving.plan.evictions"
SERVING_MODEL_SWAPS = "serving.model.swaps"
SERVING_MODEL_SWAP_ERRORS = "serving.model.swap_errors"
PLAN_COMPILES = "plan.compiles"
PLAN_RECOMPILES = "plan.recompiles"
QUALITY_LABELS_JOINED = "quality.labels.joined"
QUALITY_LABELS_LATE = "quality.labels.late"
QUALITY_LABELS_DUP = "quality.labels.dup"
QUALITY_LABELS_DROPPED = "quality.labels.dropped"
QUALITY_JOIN_SUBSCRIBER_ERRORS = "quality.join.subscriber_errors"
QUALITY_SKETCH_ROWS = "quality.sketch.rows"

CHECKPOINT_SAVE_COUNT = "checkpoint.save.count"
CHECKPOINT_SAVE_BYTES = "checkpoint.save.bytes"
CHECKPOINT_CORRUPT_SKIPPED = "checkpoint.corrupt_skipped"
CHECKPOINT_DIGEST_MISMATCH = "checkpoint.digest_mismatch"
CHECKPOINT_WRITE_COALESCED = "checkpoint.write.coalesced"
CHECKPOINT_WRITE_ERRORS = "checkpoint.write.errors"
CHECKPOINT_FINALIZE_ERRORS = "checkpoint.finalize_errors"

# the training supervisor
TRAIN_RESUMES = "train.resumes"
TRAIN_STEP_RESTARTS = "train.step_restarts"
TRAIN_STEP_TIMEOUTS = "train.step_timeouts"
TRAIN_STEP_RETRIES = "train.step_retries"
TRAIN_PREEMPTED = "train.preempted"
TRAIN_PREEMPT_SIGNALS = "train.preempt_signals"
RETRY_RETRIES = "retry.retries"

# the cluster: rendezvous, heartbeats, fences, the data axis' exchange
CLUSTER_REJOINS = "cluster.rejoins"
CLUSTER_HEARTBEAT_ERRORS = "cluster.heartbeat_errors"
CLUSTER_RENDEZVOUS_RETRIES = "cluster.rendezvous_retries"
CLUSTER_FENCE_REJECTS = "cluster.fence_rejects"
CLUSTER_HEARTBEAT_TMP_SWEPT = "cluster.heartbeat_tmp_swept"
CLUSTER_EXCHANGES = "cluster.exchanges"
CLUSTER_EXCHANGE_BYTES = "cluster.exchange_bytes"

# elastic shrink-resume
ELASTIC_MANIFEST_COMMITS = "elastic.manifest.commits"
ELASTIC_MANIFEST_REJECTED = "elastic.manifest.rejected"
ELASTIC_SHRINKS = "elastic.shrinks"
ELASTIC_RESUMES = "elastic.resumes"

# the data plane
DATA_WORKER_FAILURES = "data.worker_failures"
DATA_PREFETCH_ITEMS = "data.prefetch.items"
DATA_PREFETCH_STALLS = "data.prefetch.stalls"
DATA_PREFETCH_FULL = "data.prefetch.full"

# -------------------------------------------------------------------- gauges
SERVING_QUEUE_DEPTH = "serving.queue_depth"
SERVING_BATCH_OCCUPANCY = "serving.batch.occupancy"
SERVING_MODEL_VERSION_INFO = "serving.model.version_info"
QUALITY_DRIFT_MAX = "quality.drift.max"
CANARY_P99_RATIO = "canary.p99.ratio"
CANARY_ERROR_BURN = "canary.error_burn"
CANARY_DRIFT_DELTA = "canary.drift.delta"
CHECKPOINT_WRITE_PENDING = "checkpoint.write.pending"
TRAIN_RESUME_STEP = "train.resume_step"
TRAIN_GOODPUT = "train.goodput"
TRAIN_MFU = "train.mfu"
TRAIN_LOST_SECONDS = "train.lost_seconds"
TRAIN_STRAGGLERS = "train.stragglers"
CLUSTER_RESUME_EPOCH = "cluster.resume_epoch"
CLUSTER_HOSTS_LIVE = "cluster.hosts.live"
CLUSTER_HOSTS_DEAD = "cluster.hosts.dead"
DATA_OOCORE_RESIDENT_BYTES = "data.oocore.resident_bytes"
DATA_OOCORE_CURSOR = "data.oocore.cursor"
REGISTRY_REPORT_RETRIES = "registry.report_retries"
REGISTRY_EVICTIONS = "registry.evictions"
WORKLOADS_IFOREST_TREES = "workloads.iforest.trees"
WORKLOADS_SAR_RECOMMEND_ROWS = "workloads.sar.recommend.rows"
WORKLOADS_SAR_UNKNOWN_USERS = "workloads.sar.unknown_users"
WORKLOADS_IFOREST_THRESHOLD = "workloads.iforest.threshold"
WORKLOADS_SAR_CATALOG_ITEMS = "workloads.sar.catalog.items"

# ------------------------------------------------------------ histograms (ms)
SERVING_REQUEST_QUEUE = "serving.request.queue"
SERVING_REQUEST_TRANSFORM = "serving.request.transform"
SERVING_REQUEST_REPLY = "serving.request.reply"
SERVING_REQUEST_E2E = "serving.request.e2e"
PLAN_COMPILE = "plan.compile"
CHECKPOINT_SUBMIT = "checkpoint.submit"
CHECKPOINT_SNAPSHOT = "checkpoint.snapshot"
CHECKPOINT_WRITE = "checkpoint.write"
TRAIN_STEP_WALL = "train.step.wall"
# one cross-process exchange of the data axis
CLUSTER_EXCHANGE = "cluster.exchange"

# --------------------------------- wall clocks (`utils.tracing.wall_clock`)
DATA_PREFETCH_PUT = "data.prefetch.put"
DATA_BIN_CHUNK = "data.bin_chunk"
DATA_FIT_BINS = "data.fit_bins"
DATA_APPLY_BINS = "data.apply_bins"
DATA_STAGE_BINNED = "data.stage_binned"
DATA_TABLE_TRANSFORM = "data.table_transform"

# --------------------------------------------------------------------- spans
SERVING_REQUEST_SPAN = "serving.request"
SERVING_PARTITION_TRANSFORM_SPAN = "serving.partition.transform"
SERVING_PLAN_RUN_SPAN = "serving.plan.run"
PLAN_COMPILE_SPAN = "plan.compile"
DEVICE_PROFILE_SPAN = "device.profile"

# -------------------------------------------------------------------- events
FAULT_INJECTED_EVENT = "fault.injected"
SERVING_MODEL_SWAP_EVENT = "serving.model.swap"
TRAIN_STRAGGLER_EVENT = "train.straggler"
TRAIN_CHUNK_REASSIGN_EVENT = "train.chunk.reassign"
TRAIN_HOST_DEAD_EVENT = "train.host.dead"
ELASTIC_PLAN_EVENT = "elastic.plan"
ELASTIC_RESUME_EVENT = "elastic.resume"


# ------------------------------------------------------ patterned names
def train_step_phase(phase: str) -> str:
    """train.step.{phase} — per-phase step-time histogram."""
    return f"train.step.{phase}"


def data_pool_maps(mode: str) -> str:
    """data.pool.{mode}_maps — per-backend WorkerPool map counter."""
    return f"data.pool.{mode}_maps"


def data_pool_map_timing(mode: str) -> str:
    """data.pool.map[{mode}] — per-backend map wall-clock label."""
    return f"data.pool.map[{mode}]"


def quality_drift(col: str) -> str:
    """quality.drift.{col} — per-column PSI drift gauge."""
    return f"quality.drift.{col}"


def quality_eval(metric: str) -> str:
    """quality.eval.{metric} — streaming-evaluation metric gauge."""
    return f"quality.eval.{metric}"
