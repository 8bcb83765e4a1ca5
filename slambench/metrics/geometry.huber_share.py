"""``geometry.huber_share``: the median, over the profiled frames that
entered in TRACKING, of the share, in percent, of the two-frame BA's valid
observations whose whitened residual at the BA's result exceeds the
configuration's ``huber_delta`` (``ops/ba.huber_share`` on the problem
and result of the BA the step solved, read by ``slambench/counters.py``;
0 without a delta): a guard on what the Huber kernel acts on, not a time.
Nothing where the port has no ``ba.huber_share``."""

from slambench import counters, stats

LAYER = "geometry"
UNIT = "%"
MOVES = "frames_per_s"
COUNTER = "ba_robust"


def read(run):
    values = counters.tracking(run, COUNTER)
    return None if values is None else 100.0 * stats.median(values)
