"""``geometry.pnp_ms``: median host time, per frame, of the tracker's span
``vo_jit.track.pnp`` (P3P-RANSAC with its DLT refit and Gauss-Newton
polish, and the inlier count) in the profiled frames that entered in
TRACKING (``slambench/stages.py``)."""

from slambench import stages, stats

LAYER = "geometry"
UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    s = stages.tracking(run, "vo_jit.track.pnp")
    return 1e3 * stats.median(s.host_s) if s is not None else None
