"""``vo_jit.track_ms``: median host time of the step's state half (``make_vo_pipelined``'s
``combine``: ``vo_jit.combine_fn`` -> ``do_track``) on the traced window's
frames that enter in TRACKING, the device drained before and after."""

from slambench.metrics import span_ms

LAYER = "state machine"
UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    return span_ms(run, "vo_jit.track")
