"""Profiling hooks and host wall clocks.

Port of the reference's `utils/tracing.py` on `torch.profiler`:

- `trace(log_dir)` captures a profile of the enclosed block (host ranges,
  and the card's kernels when a card is visible) and writes it under
  `log_dir` as a Chrome/Perfetto trace (`*.pt.trace.json`, through
  `torch.profiler.tensorboard_trace_handler`), inside a `device.profile`
  span;
- `annotate(name)` marks a named region (`torch.profiler.record_function`:
  a range on a captured profile's timeline) and activates it for
  plan-build records (`telemetry.perf`), as the reference's region does;
- `wall_clock(label, sink=, tracer=)` times a block on the host into a
  `(label, seconds)` sink, a telemetry span, or the console. The data
  plane times its staging and binning passes with it into
  `reliability.metrics.reliability_metrics.observe`.

The reference's triggered profile sessions and their roofline ledger
(`telemetry/profiler.py`) are ROADMAP Queue 1 item 23.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import time
from typing import Optional

_region: contextvars.ContextVar = contextvars.ContextVar(
    "mmlspark_tpu_torch_region", default=None)


def current_region() -> Optional[str]:
    """The innermost `annotate` region active on this thread, or None."""
    return _region.get()


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a profile of the enclosed block into `log_dir`:

        with tracing.trace("/tmp/trace"):
            model.fit(table)
    """
    if create_perfetto_link:
        raise NotImplementedError(
            "utils.tracing.trace(create_perfetto_link=True), the "
            "reference's Perfetto link, is not ported yet (ROADMAP Queue 1 "
            "item 23)")
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    from ..telemetry import names as tnames
    from ..telemetry.spans import get_tracer
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with get_tracer().span(tnames.DEVICE_PROFILE_SPAN, log_dir=log_dir):
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(log_dir)):
            yield log_dir


@contextlib.contextmanager
def annotate(name: str):
    """Named region: a `torch.profiler.record_function` range, and the
    region a plan build recorded inside it is tagged with."""
    import torch
    token = _region.set(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        _region.reset(token)


@contextlib.contextmanager
def wall_clock(label: str, sink=None, tracer=None):
    """Host-side wall clock for a block; `sink(label, seconds)` or print.

    `tracer` routes the timing into the telemetry span log instead of the
    console: pass a `telemetry.spans.Tracer` (or `True` for the process
    default) and the block lands as a span named `label`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        recorded = None
        if tracer is not None:
            if tracer is True:
                from ..telemetry.spans import get_tracer
                tracer = get_tracer()
            recorded = tracer.observe(label, dt)
        if sink is not None:
            sink(label, dt)
        elif tracer is None or recorded is None:
            # an unsampled span records nothing: a timing the caller asked
            # for must not vanish, so fall back to the print
            print(f"{label}: {dt:.4f}s")
