"""LabelFeed: the bounded bridge from label joins to minibatches.

Port of the reference's `online/stream.py`: host Python over the port's
`StreamingEvaluator` (`telemetry/quality.py`, its `on_join` hook).

The serving path knows features by request id (the client reads the id
back from the `X-Request-Id` header); the `StreamingEvaluator` knows
when a delayed label joins its prediction. `LabelFeed` subscribes to
those joins (the `on_join` hook) and assembles the third thing the
learner needs: (features, label, weight) triples, buffered as
minibatch-ready arrays.

Both buffers are bounded and every loss is COUNTED, never raised —
the feed lives on the serving path's side of the house and inherits
its assumptions about hostile input:

- features whose label never arrives age out of the bounded feature
  window silently (they were never a pair);
- a join whose features already aged out counts `online.feed.dropped`;
- pair-buffer overflow evicts oldest-first, counted the same.

Determinism: the feed does no I/O and holds no clock — replaying the
same (record_features, on_join) sequence yields byte-identical
minibatches, which is what the chaos tests lean on.
"""
from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Optional, Tuple

import numpy as np

from ..reliability.metrics import reliability_metrics
from ..telemetry import names as tnames


class LabelFeed:
    """Bounded (features, label, weight) minibatch buffer.

    Parameters
    ----------
    evaluator:     optional `StreamingEvaluator` to subscribe to; when
                   None, call `on_join(rid, pred, label)` directly (the
                   deterministic-replay path tests use).
    max_pairs:     joined-pair buffer bound; overflow evicts oldest.
    max_features:  pending-features window bound (predictions whose
                   label hasn't arrived yet).
    """

    def __init__(self, evaluator=None, max_pairs: int = 4096,
                 max_features: int = 8192, default_weight: float = 1.0,
                 metrics=None):
        self.max_pairs = max(int(max_pairs), 1)
        self.max_features = max(int(max_features), 1)
        self.default_weight = float(default_weight)
        self._metrics = metrics if metrics is not None \
            else reliability_metrics
        self._lock = threading.Lock()
        self._features: OrderedDict = OrderedDict()  # rid -> (idx, val, w)
        self._pairs: deque = deque()                 # (idx, val, y, w)
        self.joined_total = 0
        self.dropped_total = 0
        if evaluator is not None:
            evaluator.subscribe(self.on_join)

    # -- feature side ---------------------------------------------------------
    def record_features(self, request_ids, idx, val, weights=None) -> None:
        """Stage a served batch's features under their request ids.
        idx/val are the (n, k) hashed-pair arrays the row was scored
        with; per-row weight defaults to `default_weight`."""
        idx = np.asarray(idx, np.int32)
        val = np.asarray(val, np.float32)
        if idx.ndim != 2 or idx.shape != val.shape:
            raise ValueError("idx/val must be matching (n, k) arrays")
        if len(request_ids) != idx.shape[0]:
            raise ValueError("one request id per row required")
        if weights is None:
            weights = [self.default_weight] * idx.shape[0]
        with self._lock:
            for i, rid in enumerate(request_ids):
                self._features[str(rid)] = (idx[i].copy(), val[i].copy(),
                                            float(weights[i]))
                while len(self._features) > self.max_features:
                    # silent age-out: not yet a pair, nothing was lost
                    self._features.popitem(last=False)

    # -- join side (the evaluator calls this) ---------------------------------
    def on_join(self, request_id: str, prediction, label) -> None:
        """One joined (prediction, label) pair from the evaluator. The
        prediction itself is not buffered — training consumes the
        features that PRODUCED it, plus the label."""
        del prediction
        with self._lock:
            feats = self._features.pop(str(request_id), None)
            if feats is None:
                self.dropped_total += 1
                self._metrics.inc(tnames.ONLINE_FEED_DROPPED)
                return
            idx_row, val_row, weight = feats
            self._pairs.append((idx_row, val_row, float(label), weight))
            while len(self._pairs) > self.max_pairs:
                self._pairs.popleft()
                self.dropped_total += 1
                self._metrics.inc(tnames.ONLINE_FEED_DROPPED)
            self.joined_total += 1
            depth = len(self._pairs)
        self._metrics.inc(tnames.ONLINE_FEED_PAIRS)
        self._metrics.set_gauge(tnames.ONLINE_BUFFER_PAIRS, depth)

    # -- learner side ---------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._pairs)

    def take(self, max_rows: Optional[int] = None
             ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                 np.ndarray, np.ndarray]]:
        """Drain up to max_rows buffered pairs, FIFO, as (idx, val, y,
        w) arrays. Rows of differing pair width are right-padded with
        idx 0 / val 0 (the zero-contribution convention). Returns None
        when empty."""
        with self._lock:
            n = len(self._pairs)
            if max_rows is not None:
                n = min(n, int(max_rows))
            if n == 0:
                return None
            rows = [self._pairs.popleft() for _ in range(n)]
            depth = len(self._pairs)
        self._metrics.set_gauge(tnames.ONLINE_BUFFER_PAIRS, depth)
        k = max(r[0].shape[0] for r in rows)
        idx = np.zeros((n, k), np.int32)
        val = np.zeros((n, k), np.float32)
        y = np.empty(n, np.float32)
        w = np.empty(n, np.float32)
        for i, (ri, rv, ry, rw) in enumerate(rows):
            idx[i, :ri.shape[0]] = ri
            val[i, :rv.shape[0]] = rv
            y[i], w[i] = ry, rw
        return idx, val, y, w

    def stats(self) -> dict:
        with self._lock:
            return {"pairs": len(self._pairs),
                    "pending_features": len(self._features),
                    "joined_total": self.joined_total,
                    "dropped_total": self.dropped_total}
