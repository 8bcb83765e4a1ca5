"""``vo_jit.host_reads_per_frame``: the synchronising calls (``stages.
SYNC_CALLS``) inside the step's two halves, ``vo_jit.pre`` and
``vo_jit.combine``, per profiled frame that entered in TRACKING
(``slambench/stages.py``). The harness's own pose copy is not counted."""

from slambench import stages

LAYER = "state machine"
UNIT = "reads/frame"
MOVES = "frames_per_s"


def read(run):
    halves = [stages.tracking(run, n) for n in ("vo_jit.pre",
                                                "vo_jit.combine")]
    if any(s is None for s in halves):
        return None
    return sum(sum(s.reads) for s in halves) / len(halves[0].reads)
