"""Shared streaming-statistics kernels: one copy of the Chan/Welford
parallel moment combine (port of the reference's `utils/stats.py`),
used by both `train.metrics.RegressionState` and
`telemetry.quality._Moments`, so the two mergeable-moments consumers
cannot drift on the n == 0 edges or the combine order.
"""
from __future__ import annotations


def merge_moments(n_a: int, mean_a: float, m2_a: float,
                  n_b: int, mean_b: float, m2_b: float) -> tuple:
    """Chan's parallel combine for (count, mean, M2-sum-of-squared-
    deviations): exact over any chunking of the same rows up to float
    association, and numerically stable where raw sum/sum-of-squares
    cancellation is not (labels with a large mean offset)."""
    if n_b == 0:
        return n_a, mean_a, m2_a
    if n_a == 0:
        return n_b, mean_b, m2_b
    n = n_a + n_b
    delta = mean_b - mean_a
    mean = mean_a + delta * n_b / n
    m2 = m2_a + m2_b + delta * delta * n_a * n_b / n
    return n, mean, m2
