"""The metric names the port records, copied from the reference's
`telemetry/names.py` (the same strings, so a dashboard reads either
package): the checkpoint path, the data plane (`data/`) and the training
supervisor with its goodput clock, and the multi-process layer
(`parallel.cluster`, `reliability.elastic`, the straggler detector).
Telemetry proper is ROADMAP Queue 1 item 23."""

CHECKPOINT_SAVE_COUNT = "checkpoint.save.count"
CHECKPOINT_SAVE_BYTES = "checkpoint.save.bytes"
CHECKPOINT_CORRUPT_SKIPPED = "checkpoint.corrupt_skipped"
CHECKPOINT_DIGEST_MISMATCH = "checkpoint.digest_mismatch"
CHECKPOINT_WRITE_COALESCED = "checkpoint.write.coalesced"
CHECKPOINT_WRITE_ERRORS = "checkpoint.write.errors"
CHECKPOINT_WRITE_PENDING = "checkpoint.write.pending"
CHECKPOINT_FINALIZE_ERRORS = "checkpoint.finalize_errors"
# histograms (ms)
CHECKPOINT_SUBMIT = "checkpoint.submit"
CHECKPOINT_SNAPSHOT = "checkpoint.snapshot"
CHECKPOINT_WRITE = "checkpoint.write"

# the training supervisor (counters, gauges)
TRAIN_RESUMES = "train.resumes"
TRAIN_STEP_RESTARTS = "train.step_restarts"
TRAIN_STEP_TIMEOUTS = "train.step_timeouts"
TRAIN_STEP_RETRIES = "train.step_retries"
TRAIN_PREEMPTED = "train.preempted"
TRAIN_PREEMPT_SIGNALS = "train.preempt_signals"
TRAIN_RESUME_STEP = "train.resume_step"
RETRY_RETRIES = "retry.retries"

# the goodput clock (gauges; the step wall and its phases are histograms)
TRAIN_GOODPUT = "train.goodput"
TRAIN_MFU = "train.mfu"
TRAIN_LOST_SECONDS = "train.lost_seconds"
TRAIN_STEP_WALL = "train.step.wall"

# the cluster: rendezvous, heartbeats, fences (counters; gauges below)
CLUSTER_REJOINS = "cluster.rejoins"
CLUSTER_HEARTBEAT_ERRORS = "cluster.heartbeat_errors"
CLUSTER_RENDEZVOUS_RETRIES = "cluster.rendezvous_retries"
CLUSTER_FENCE_REJECTS = "cluster.fence_rejects"
CLUSTER_HEARTBEAT_TMP_SWEPT = "cluster.heartbeat_tmp_swept"
CLUSTER_EXCHANGES = "cluster.exchanges"
CLUSTER_EXCHANGE_BYTES = "cluster.exchange_bytes"
# gauges
CLUSTER_RESUME_EPOCH = "cluster.resume_epoch"
CLUSTER_HOSTS_LIVE = "cluster.hosts.live"
CLUSTER_HOSTS_DEAD = "cluster.hosts.dead"
TRAIN_STRAGGLERS = "train.stragglers"
# histogram (ms): one cross-process exchange of the data axis
CLUSTER_EXCHANGE = "cluster.exchange"

# elastic shrink-resume (counters)
ELASTIC_MANIFEST_COMMITS = "elastic.manifest.commits"
ELASTIC_MANIFEST_REJECTED = "elastic.manifest.rejected"
ELASTIC_SHRINKS = "elastic.shrinks"
ELASTIC_RESUMES = "elastic.resumes"

# events (a tracer's and a run ledger's names; the tracer is item 23)
TRAIN_STRAGGLER_EVENT = "train.straggler"
TRAIN_CHUNK_REASSIGN_EVENT = "train.chunk.reassign"
TRAIN_HOST_DEAD_EVENT = "train.host.dead"
ELASTIC_PLAN_EVENT = "elastic.plan"
ELASTIC_RESUME_EVENT = "elastic.resume"

# the data plane: counters
DATA_WORKER_FAILURES = "data.worker_failures"
DATA_PREFETCH_ITEMS = "data.prefetch.items"
DATA_PREFETCH_STALLS = "data.prefetch.stalls"
DATA_PREFETCH_FULL = "data.prefetch.full"
# gauges
DATA_OOCORE_RESIDENT_BYTES = "data.oocore.resident_bytes"
DATA_OOCORE_CURSOR = "data.oocore.cursor"
# wall clocks (`utils.tracing.wall_clock` labels)
DATA_PREFETCH_PUT = "data.prefetch.put"
DATA_BIN_CHUNK = "data.bin_chunk"
DATA_FIT_BINS = "data.fit_bins"
DATA_APPLY_BINS = "data.apply_bins"
DATA_STAGE_BINNED = "data.stage_binned"
DATA_TABLE_TRANSFORM = "data.table_transform"


def train_step_phase(phase: str) -> str:
    """train.step.{phase} — per-phase step-time histogram."""
    return f"train.step.{phase}"


def data_pool_maps(mode: str) -> str:
    """data.pool.{mode}_maps — per-backend WorkerPool map counter."""
    return f"data.pool.{mode}_maps"


def data_pool_map_timing(mode: str) -> str:
    """data.pool.map[{mode}] — per-backend map wall-clock label."""
    return f"data.pool.map[{mode}]"
