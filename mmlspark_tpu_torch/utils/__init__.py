"""Utilities of the port: step checkpoints (`checkpoint.CheckpointManager`)."""
