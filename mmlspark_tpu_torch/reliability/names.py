"""The metric names the port's checkpoint path records, copied from the
reference's `telemetry/names.py` (the same strings, so a dashboard reads
either package). Telemetry proper is ROADMAP Queue 1 item 23."""

CHECKPOINT_SAVE_COUNT = "checkpoint.save.count"
CHECKPOINT_SAVE_BYTES = "checkpoint.save.bytes"
CHECKPOINT_CORRUPT_SKIPPED = "checkpoint.corrupt_skipped"
CHECKPOINT_DIGEST_MISMATCH = "checkpoint.digest_mismatch"
CHECKPOINT_WRITE_COALESCED = "checkpoint.write.coalesced"
CHECKPOINT_WRITE_ERRORS = "checkpoint.write.errors"
CHECKPOINT_WRITE_PENDING = "checkpoint.write.pending"
# histograms (ms)
CHECKPOINT_SUBMIT = "checkpoint.submit"
CHECKPOINT_WRITE = "checkpoint.write"
