"""``geometry.ba_fused_share``: the share, in percent, of the profiled
frames that entered in TRACKING whose span ``vo_jit.track.ba`` holds the
span ``vo_jit.track.ba.fused``, i.e. whose two-frame BA ran as the one
hand-written kernel launch (``slambench/stages.py``); nothing where the
port has no such span."""

from slambench import stages

LAYER = "geometry"
UNIT = "%"
MOVES = "frames_per_s"
SPAN = "vo_jit.track.ba.fused"


def read(run):
    if SPAN not in stages.SPANS:
        return None
    ba = stages.tracking(run, "vo_jit.track.ba")
    if ba is None:
        return None
    fused = stages.tracking(run, SPAN)
    n = 0 if fused is None else len(fused.host_s)
    return 100.0 * n / len(ba.host_s)
