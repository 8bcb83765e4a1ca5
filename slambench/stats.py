"""The arithmetic of the end-to-end metrics and of the spreads that set
their bounds."""

from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of all ``values``, linear between the
    two nearest ranks (numpy's default)."""
    if len(values) == 0:
        raise ValueError("percentile of no values")
    return float(np.percentile(np.asarray(values, np.float64), q))


def rate(count: int, seconds: float) -> float:
    """Work completed per second over the whole window: a stall inside it
    lowers the rate by its whole length."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def median(values: Sequence[float]) -> float:
    return float(statistics.median(values))


def spread(values: Sequence[float]) -> float:
    """Distance between the first and the third quartile
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
