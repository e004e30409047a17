"""Profiling hooks and host wall clocks.

Port of the reference's `utils/tracing.py` on `torch.profiler`:

- `trace(log_dir)` captures a profile of the enclosed block (host ranges,
  and the card's kernels when a card is visible) and writes it under
  `log_dir` as a Chrome/Perfetto trace (`*.pt.trace.json`). It rests on
  `telemetry.profiler.ProfileSession.session(force=True)`: the one
  capture path of the triggered captures, with the same
  `device.profile` span, `trace_context.json` stamp and per-op parse
  feeding the roofline ledger. `create_perfetto_link=True` then serves
  the trace on a localhost port and logs the `ui.perfetto.dev` link that
  opens it (`telemetry.profiler.serve_perfetto_link`).
- `annotate(name)` marks a named region: a `torch.profiler.record_function`
  range on a captured profile's timeline, the region plan-build records
  made inside are tagged with (`telemetry.profiler.current_region`), a
  host-wall note into the roofline ledger on exit, and, while a capture
  runs, the region's host interval for the parse. It adds no host
  synchronisation.
- `wall_clock(label, sink=, tracer=)` times a block on the host into a
  `(label, seconds)` sink, a telemetry span, or the console. The data
  plane times its staging and binning passes with it into
  `reliability.metrics.reliability_metrics.observe`.
"""
from __future__ import annotations

import contextlib
import time

from ..telemetry.profiler import current_region  # noqa: F401 (re-export)


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a profile of the enclosed block into `log_dir`:

        with tracing.trace("/tmp/trace"):
            model.fit(table)

    Never rate-limited (force=True), and the caller owns `log_dir` (no
    retention pruning). With `create_perfetto_link=True` the block's exit
    waits until the trace has been fetched through the logged
    `ui.perfetto.dev` link, or `telemetry.profiler.PERFETTO_TIMEOUT_S`
    (120 s) has passed. Raises `telemetry.profiler.ProfilerBusy` while
    another profiler of the process runs."""
    from ..telemetry.profiler import get_profile_session
    with get_profile_session().session(
            reason="trace", log_dir=log_dir, force=True,
            create_perfetto_link=create_perfetto_link):
        yield log_dir


@contextlib.contextmanager
def annotate(name: str):
    """Named region (module docstring): a `record_function` range, the
    active region of build records, a host-wall note into the roofline
    ledger, and the region's interval for a running capture."""
    import torch

    from ..telemetry import profiler as _prof
    t0 = time.perf_counter()
    n0 = time.time_ns()
    try:
        with _prof.region(name), torch.profiler.record_function(name):
            yield
    finally:
        _prof.note_interval(name, n0, time.time_ns())
        _prof.note_region(name, time.perf_counter() - t0)


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
