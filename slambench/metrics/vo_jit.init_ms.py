"""``vo_jit.init_ms``: median host time of the step's state half (``combine`` ->
``do_init``) on the traced window's frames that enter in INITIALIZING,
the device drained before and after. The window starts from a fresh
tracker, so its first frames bootstrap; resets add more."""

from slambench.metrics import span_ms

LAYER = "state machine"
UNIT = "ms"
MOVES = "frames_per_s"


def read(run):
    return span_ms(run, "vo_jit.init")
