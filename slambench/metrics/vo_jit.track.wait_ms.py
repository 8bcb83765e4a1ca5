"""``vo_jit.track.wait_ms``: median, per profiled frame that entered in
TRACKING, of the host's summed wait in the synchronising calls inside the
span ``vo_jit.track`` (``slambench/stages.py``)."""

from slambench import stages, stats

LAYER = "state machine"
UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    s = stages.tracking(run, "vo_jit.track")
    return 1e3 * stats.median(s.wait_s) if s is not None else None
