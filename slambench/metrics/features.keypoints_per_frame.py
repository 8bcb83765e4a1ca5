"""``features.keypoints_per_frame``: the median, over the profiled frames
that entered in TRACKING, of the keypoints the step's feature half kept
(the count of the state's ``lf_mask`` after the frame, read by
``slambench/counters.py``): a guard, so that a speed-up that keeps fewer
features shows. Nothing where the port's state has no ``lf_mask``."""

from slambench import counters, stats

LAYER = "feature front"
UNIT = "keypoints/frame"
MOVES = "frames_per_s"
COUNTER = "n_keypoints"


def read(run):
    values = counters.tracking(run, COUNTER)
    return None if values is None else stats.median(values)
