"""Host wall clocks for a block of code.

Port of `wall_clock` from the reference's `utils/tracing.py:80`, without
its tracer branch (spans are ROADMAP Queue 1 item 23): the data plane
times its staging and binning passes with it into
`reliability.metrics.reliability_metrics.observe`.
"""
from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def wall_clock(label: str, sink=None):
    """Host-side wall clock for a block; `sink(label, seconds)` or print."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if sink is not None:
            sink(label, dt)
        else:
            print(f"{label}: {dt:.4f}s")
