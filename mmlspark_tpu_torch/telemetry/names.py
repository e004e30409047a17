"""The metric, span, event and fault-site names the port records, in one
place.

The strings are the reference's (`mmlspark_tpu/telemetry/names.py`), so a
dashboard, a scrape merge or an alert reads either package: the
checkpoint path, the training supervisor and its goodput clock, the
multi-process layer, the data plane, the serving stack (ingress,
partition workers, the plan cache, hot-swap, the service registry), the
fleet workloads (isolation forest, SAR), its compile log, the
model-quality tap, the version registry's canary gauges, the online
learning loop, the control plane (rollout, admission, routing, scaling),
the telemetry watcher, the flight recorder, the profile session and its
roofline gauges, the resource gauges, the HTTP client's retries, the circuit
breakers' trips and the tracer's spans and events. `reliability/names.py` re-exports this module, so the
names its callers import there are these.

Dotted `subsystem.signal[.detail]`, lowercase; a patterned name carries a
`{placeholder}` that a helper below renders. A fault site keeps its
literal at its `fire`/`perturb` call ("serving.worker", "serving.ingress",
"serving.swap", "quality.label", "train.ckpt.write", "online.refit",
"control.rollout.poll").
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
PLAN_COLLECTIVE_OPS = "plan.collective_ops"
PLAN_COLLECTIVE_BYTES = "plan.collective_bytes"
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
# the HTTP client transformers' advanced handler (io/http.py)
HTTP_RETRIES = "http.retries"

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

# online learning: the label feed, the learner, the continuous loop
ONLINE_FEED_PAIRS = "online.feed.pairs"
ONLINE_FEED_DROPPED = "online.feed.dropped"
ONLINE_LEARNER_UPDATES = "online.learner.updates"
ONLINE_TRIPS = "online.trips"
ONLINE_REFITS = "online.refits"
ONLINE_REFIT_RETRIES = "online.refit_retries"
ONLINE_PROMOTIONS = "online.promotions"
ONLINE_ROLLBACKS = "online.rollbacks"

# the control plane and the telemetry watcher
CONTROL_ROLLOUT_STEPS = "control.rollout.steps"
CONTROL_ROLLOUT_PROMOTIONS = "control.rollout.promotions"
CONTROL_ROLLOUT_ROLLBACKS = "control.rollout.rollbacks"
CONTROL_ROLLOUT_ROLLBACK_RETRIES = "control.rollout.rollback_retries"
CONTROL_ROLLOUT_POLL_ERRORS = "control.rollout.poll_errors"
CONTROL_ADMISSION_SHED = "control.admission.shed"
CONTROL_ROUTER_UPDATES = "control.router.updates"
CONTROL_SCALER_SPAWNS = "control.scaler.spawns"
CONTROL_SCALER_DRAINS = "control.scaler.drains"
TELEMETRY_WATCH_TRIPS = "telemetry.watch.trips"

# the flight recorder and the profile session
TELEMETRY_BUNDLE_DUMPS = "telemetry.bundle.dumps"
TELEMETRY_BUNDLE_SUPPRESSED = "telemetry.bundle.suppressed"
TELEMETRY_PROFILE_CAPTURES = "telemetry.profile.captures"
TELEMETRY_PROFILE_SUPPRESSED = "telemetry.profile.suppressed"
TELEMETRY_PROFILE_STAMP_ERRORS = "telemetry.profile.stamp_errors"
# the port's own: captures refused because another torch.profiler of the
# process was running (one profiler at a time)
TELEMETRY_PROFILE_BUSY = "telemetry.profile.busy"

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
ONLINE_BUFFER_PAIRS = "online.buffer.pairs"
CONTROL_ROLLOUT_FRACTION = "control.rollout.fraction"
TELEMETRY_WATCH_TRIPPED = "telemetry.watch.tripped"
# resident level-invariant one-hot plane bytes built for the current fit
# (MMLSPARK_TPU_HIST=planes)
GBDT_HIST_PLAN_BYTES = "gbdt.hist.plan.bytes"
# bytes in use summed over local devices (absent where the allocator has
# no device), their peak, and the host process's resident set size
DEVICE_MEM_BYTES_IN_USE = "device.mem.bytes_in_use"
DEVICE_MEM_PEAK_BYTES = "device.mem.peak_bytes"
HOST_RSS_BYTES = "host.rss_bytes"

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
TRAIN_STEP_SPAN = "train.step"
CHECKPOINT_WRITE_SPAN = "checkpoint.write"
DATA_PREFETCH_SPAN = "data.prefetch"

# the port's own profile-session regions (`telemetry/profiler.py`
# `PORT_REGIONS`): an image decode's host half (file reads, the PNG chunk
# walk and inflate, JPEG's Huffman decoding) and its card half (the four
# decoder kernels, the PNG expansion and the copy back)
IMAGE_DECODE_HOST = "image.decode.host"
IMAGE_DECODE_CARD = "image.decode.card"

# -------------------------------------------------------------------- events
FAULT_INJECTED_EVENT = "fault.injected"
SERVING_MODEL_SWAP_EVENT = "serving.model.swap"
TRAIN_STRAGGLER_EVENT = "train.straggler"
TRAIN_CHUNK_REASSIGN_EVENT = "train.chunk.reassign"
TRAIN_HOST_DEAD_EVENT = "train.host.dead"
ELASTIC_PLAN_EVENT = "elastic.plan"
ELASTIC_RESUME_EVENT = "elastic.resume"
TELEMETRY_WATCH_TRIP_EVENT = "telemetry.watch.trip"
TELEMETRY_BUNDLE_EVENT = "telemetry.bundle"
TELEMETRY_PROFILE_EVENT = "telemetry.profile"
TRAIN_RESUME_EVENT = "train.resume"
TRAIN_RESTART_EVENT = "train.restart"
TRAIN_PREEMPTED_EVENT = "train.preempted"
CONTROL_ROLLOUT_DEPLOY_EVENT = "control.rollout.deploy"
CONTROL_ROLLOUT_STEP_EVENT = "control.rollout.step"
CONTROL_ROLLOUT_BURN_EVENT = "control.rollout.burn"
CONTROL_ROLLOUT_PROMOTE_EVENT = "control.rollout.promote"
CONTROL_ROLLOUT_ROLLBACK_EVENT = "control.rollout.rollback"
CONTROL_ROLLOUT_RECOVERED_EVENT = "control.rollout.recovered"
ONLINE_TRIP_EVENT = "online.trip"
ONLINE_REFIT_EVENT = "online.refit"
ONLINE_DEPLOY_EVENT = "online.deploy"
ONLINE_PROMOTE_EVENT = "online.promote"
ONLINE_ROLLBACK_EVENT = "online.rollback"


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


def device_mem_in_use(ordinal: int) -> str:
    """device{ordinal}.mem.bytes_in_use — per-device in-use gauge."""
    return f"device{ordinal}.mem.bytes_in_use"


def device_mem_peak(ordinal: int) -> str:
    """device{ordinal}.mem.peak_bytes — per-device peak gauge."""
    return f"device{ordinal}.mem.peak_bytes"


def op_hbm_util(region: str) -> str:
    """op.{region}.hbm_util — per-region roofline HBM utilization."""
    return f"op.{region}.hbm_util"


def op_flops_util(region: str) -> str:
    """op.{region}.flops_util — per-region roofline FLOPs utilization."""
    return f"op.{region}.flops_util"


def quality_drift(col: str) -> str:
    """quality.drift.{col} — per-column PSI drift gauge."""
    return f"quality.drift.{col}"


def quality_eval(metric: str) -> str:
    """quality.eval.{metric} — streaming-evaluation metric gauge."""
    return f"quality.eval.{metric}"


def breaker_trips(breaker: str) -> str:
    """{breaker}.trips — per-breaker trip counter."""
    return f"{breaker}.trips"


def control_router_weight(target: str) -> str:
    """control.router.weight.{target} — per-target router weight gauge."""
    return f"control.router.weight.{target}"
