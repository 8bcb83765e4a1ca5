"""``features.preprocess_ms``: median host time of the step's feature half (``make_vo_pipelined``'s
``pre``: ``vo_jit.preprocess`` -> ``ops/features.orb_detect``, KLT
templates) on the traced window's frames, the device drained before and
after."""

from slambench.metrics import span_ms

LAYER = "feature front"
UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    return span_ms(run, "features.preprocess")
