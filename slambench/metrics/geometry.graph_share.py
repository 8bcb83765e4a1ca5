"""``geometry.graph_share``: the share, in percent, of the profiled frames
that entered in TRACKING whose span ``vo_jit.track`` holds the span
``vo_jit.track.graphed``, i.e. whose four geometry stages replayed as CUDA
graphs (``slambench/stages.py``); nothing where the port has no such
span."""

from slambench import stages

LAYER = "geometry"
UNIT = "%"
MOVES = "frames_per_s"
SPAN = "vo_jit.track.graphed"


def read(run):
    if SPAN not in stages.SPANS:
        return None
    track = stages.tracking(run, "vo_jit.track")
    if track is None:
        return None
    graphed = stages.tracking(run, SPAN)
    n = 0 if graphed is None else len(graphed.host_s)
    return 100.0 * n / len(track.host_s)
