"""Step-level checkpointing: atomic, retained, resumable.

Port of the reference's `utils/checkpoint.py` (which imports no JAX), with
the same on-disk format, so each package restores the other's steps.
Layout:

    <dir>/step_<k>/payload.npz + meta.json     (atomic via tmp + os.replace)

save() keeps the newest `max_to_keep` steps; restore() loads the latest (or
a named step). Payloads are dicts of numpy arrays + JSON-able scalars, so
any model that can serialize to arrays/strings can checkpoint through this.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import tempfile
import zipfile

import numpy as np

from ..reliability import names as tnames
from ..reliability.metrics import reliability_metrics

logger = logging.getLogger(__name__)


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def array_sha256(arr) -> str:
    """SHA-256 of one array's CONTENT, qualified by dtype and shape (a
    float32 zero vector does not collide with the float64 one), over its
    C-contiguous bytes, so the digest does not depend on the source's
    strides: the reference's fitted-weight digest."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(f"{a.dtype}{a.shape}:".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _canonical_meta(meta: dict) -> bytes:
    """Canonical bytes of the meta payload (sans the _digests record) for
    content digesting: sort_keys + fixed separators make the dump identical
    before write and after a json.load round-trip."""
    rest = {k: v for k, v in meta.items() if k != "_digests"}
    return json.dumps(rest, sort_keys=True,
                      separators=(",", ":")).encode()


def _fsync_path(path: str) -> None:
    """fsync a file or directory so the atomic rename survives power loss,
    not just process kill (a rename without the dir fsync can resurface as
    neither-old-nor-new after a crash)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return   # platforms without dir-fd fsync: best effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)

# everything a truncated/corrupt payload.npz or meta.json can raise out of
# np.load/json.load: torn zip central directory (BadZipFile), short reads
# (EOFError/OSError), garbage JSON (ValueError covers JSONDecodeError),
# missing member (KeyError)
_CORRUPT_ERRORS = (OSError, ValueError, KeyError, EOFError,
                   zipfile.BadZipFile)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    # -- introspection ------------------------------------------------------
    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    # -- save/restore -------------------------------------------------------
    def save(self, step: int, payload: dict,
             prune_newer: bool = False) -> None:
        """Write arrays to npz + scalars/strings to JSON, atomically: the
        step directory appears only when complete (tmp dir + os.replace),
        so a killed process never leaves a half checkpoint; every written
        file plus both directories are fsync'd so the rename also survives
        POWER LOSS, not just process kill. Per-file SHA-256 digests land in
        meta.json under "_digests" and are verified on restore, so a
        silently-corrupted payload (valid zip, wrong bytes) is skipped like
        a truncated one. prune_newer removes steps beyond this one (a
        truncating save — e.g. early stopping rewinding past
        already-checkpointed work — must not leave a higher step to shadow
        it as latest)."""
        arrays, meta = {}, {}
        for k, v in payload.items():
            if k.startswith("_"):
                raise ValueError(
                    f"payload key {k!r}: leading-underscore keys are "
                    f"reserved for checkpoint metadata (_digests)")
            if isinstance(v, np.ndarray):
                arrays[k] = v
            else:
                json.dumps(v)  # raise early on unserializable values
                meta[k] = v
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
        nbytes = 0
        try:
            digests = {}
            if arrays:
                # stream to disk (no full serialized copy in RAM — a
                # multi-GB LM payload must not double peak host memory),
                # fsync, then digest the ON-DISK bytes back through the
                # still-warm page cache — hashing what the disk actually
                # holds is also the stronger integrity statement
                npz_path = os.path.join(tmp, "payload.npz")
                np.savez(npz_path, **arrays)
                _fsync_path(npz_path)
                digests["payload.npz"] = _file_sha256(npz_path)
                nbytes += os.path.getsize(npz_path)
            # the meta CONTENT is digested too (canonical serialization,
            # verified by re-canonicalizing on load): GBDT checkpoints
            # carry the whole model as a meta string — corruption that
            # stays valid JSON must not pass the integrity gate
            digests["meta"] = hashlib.sha256(
                _canonical_meta(meta)).hexdigest()
            meta["_digests"] = digests
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            nbytes += os.path.getsize(os.path.join(tmp, "meta.json"))
            _fsync_path(tmp)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            _fsync_path(self.directory)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        reliability_metrics.inc(tnames.CHECKPOINT_SAVE_COUNT)
        reliability_metrics.inc(tnames.CHECKPOINT_SAVE_BYTES, nbytes)
        if prune_newer:
            for newer in [s for s in self.all_steps() if s > step]:
                shutil.rmtree(self._step_dir(newer), ignore_errors=True)
        # retention
        steps = self.all_steps()
        for old in steps[: max(len(steps) - self.max_to_keep, 0)]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def restore(self, step: int = None, with_step: bool = False):
        """Load a step's payload. With `step=None` (latest), a step whose
        payload.npz/meta.json is truncated or corrupt is SKIPPED — restore
        falls back to the next-newest retained step (logged + counted in
        reliability metrics) instead of raising; a torn disk or killed
        copy must cost one checkpoint interval, not the whole run. An
        explicitly requested step still raises on corruption.
        `with_step=True` returns (payload, step_actually_loaded) — callers
        resuming a data cursor must key on the step that was LOADED, which
        a corrupt-step fallback makes different from latest_step()."""
        if step is not None:
            out = self._load_step(step)
            return (out, step) if with_step else out
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(
                f"no checkpoints under {self.directory!r}")
        last_err: Exception = FileNotFoundError(self.directory)
        for s in reversed(steps):
            try:
                out = self._load_step(s)
                return (out, s) if with_step else out
            except _CORRUPT_ERRORS as e:
                last_err = e
                reliability_metrics.inc(tnames.CHECKPOINT_CORRUPT_SKIPPED)
                logger.warning(
                    "checkpoint step %d under %r unreadable (%s: %s); "
                    "falling back to next-newest step", s, self.directory,
                    type(e).__name__, e)
        raise RuntimeError(
            f"all {len(steps)} retained checkpoints under "
            f"{self.directory!r} are unreadable") from last_err

    def _load_step(self, step: int) -> dict:
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        digests = meta.pop("_digests", None) if isinstance(meta, dict) else None
        if digests is not None and (
                not isinstance(digests, dict)
                or not all(isinstance(v, str) for v in digests.values())):
            # a bit-flipped _digests that still parses as JSON must read
            # as CORRUPTION (ValueError is in _CORRUPT_ERRORS, so latest-
            # mode restore falls back), not as an AttributeError crash
            raise ValueError(
                f"checkpoint step {step}: malformed _digests record "
                f"({type(digests).__name__})")
        if digests:
            # integrity gate BEFORE deserializing: silently-corrupted
            # content (valid zip / valid JSON, wrong bytes — a torn copy,
            # a bad disk) must be indistinguishable from truncation
            for name, want in digests.items():
                got = (hashlib.sha256(_canonical_meta(meta)).hexdigest()
                       if name == "meta"
                       else _file_sha256(os.path.join(d, name)))
                if got != want:
                    reliability_metrics.inc(tnames.CHECKPOINT_DIGEST_MISMATCH)
                    raise ValueError(
                        f"checkpoint step {step}: {name} sha256 mismatch "
                        f"(recorded {want[:12]}…, found {got[:12]}…)")
        out: dict = {}
        npz = os.path.join(d, "payload.npz")
        if os.path.exists(npz):
            with np.load(npz, allow_pickle=False) as z:
                out.update({k: z[k] for k in z.files})
        out.update(meta)
        return out
