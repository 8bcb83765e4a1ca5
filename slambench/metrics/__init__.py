"""Per-layer metrics: one file per metric, named as in ``BENCHMARK.json``,
each with its ``LAYER``, ``UNIT``, ``MOVES`` and ``read(run)``, which
returns the metric's value or ``None`` where the run gave nothing to read.
``run`` is ``run.Reading``: the cell, the traced window's log (its spans
in seconds), its profile and its frames. Shared arithmetic is here."""

from __future__ import annotations

from slambench import stats


def span_ms(run, name: str):
    """Median of the spans ``name`` in milliseconds, or ``None``."""
    spans = run.log.spans.get(name)
    return 1e3 * stats.median(spans) if spans else None
