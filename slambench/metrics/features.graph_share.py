"""``features.graph_share``: the share, in percent, of the profiled frames
that entered in TRACKING whose span ``vo_jit.pre`` holds the span
``vo_jit.pre.graphed``, i.e. whose feature half after K1 replayed as CUDA
graphs (``slambench/stages.py``); nothing where the port has no such
span."""

from slambench import stages

LAYER = "feature front"
UNIT = "%"
MOVES = "frame_ms_p90"
SPAN = "vo_jit.pre.graphed"


def read(run):
    if SPAN not in stages.SPANS:
        return None
    pre = stages.tracking(run, "vo_jit.pre")
    if pre is None:
        return None
    graphed = stages.tracking(run, SPAN)
    n = 0 if graphed is None else len(graphed.host_s)
    return 100.0 * n / len(pre.host_s)
