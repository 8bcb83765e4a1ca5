"""``geometry.ba_ms``: median host time, per frame, of the tracker's span
``vo_jit.track.ba`` (the two-frame bundle adjustment: the problem's
assembly and the LM solve) in the profiled frames that entered in
TRACKING (``slambench/stages.py``)."""

from slambench import stages, stats

LAYER = "geometry"
UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    s = stages.tracking(run, "vo_jit.track.ba")
    return 1e3 * stats.median(s.host_s) if s is not None else None
