"""``geometry.triangulate_ms``: median host time, per frame, of the
tracker's span ``vo_jit.track.triangulate`` (new points: matches against
the last frame, KLT, triangulation and the two-ray consistency gate) in
the profiled frames that entered in TRACKING (``slambench/stages.py``)."""

from slambench import stages, stats

LAYER = "geometry"
UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    s = stages.tracking(run, "vo_jit.track.triangulate")
    return 1e3 * stats.median(s.host_s) if s is not None else None
