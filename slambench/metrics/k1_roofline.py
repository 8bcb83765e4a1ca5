"""``k1_roofline``: K1's (``csrc/fast_nms_harris.cu``, one launch per
frame) least time over its mean device time per launch, in percent. The
least time is ``roofline.k1_bound`` of the cell's pyramid: its level
shapes, and the compass candidates and corners of the mix's
``profile_start`` frame, counted by the plain reference. Device times are
the profiler's kernel events in the traced run's profiled frames that
entered in TRACKING."""

import numpy as np

from slambench import reference, roofline
from slambench.program import reference_orb

LAYER = "kernel K1"
UNIT = "%"
MOVES = "frames_per_s"


def read(run):
    prof = run.profile
    k1_s = prof.mode("tracking").k1_s if prof is not None else []
    if not k1_s:
        return None
    orb = reference_orb(run.cell.config)
    frame = run.cell.traffic.profile_start
    img = reference.to_image(run.frames[frame].to(run.device))
    levels = reference.pyramid(img, orb)
    cand = sum(roofline.compass_candidates(lv, orb.fast_threshold)
               for lv in levels)
    corners = sum(int(np.isfinite(reference.rank_map(lv, orb).cpu()
                                  .numpy()).sum()) for lv in levels)
    bound = roofline.k1_bound([tuple(lv.shape) for lv in levels], cand,
                              corners)
    return 100.0 * bound["seconds"] / float(np.mean(k1_s))
