"""``device.launches_per_frame``: CUDA kernels the device ran in the traced
run's profiled frames that entered in TRACKING, per such frame."""

LAYER = "device"
UNIT = "launches/frame"
MOVES = "frames_per_s"


def read(run):
    prof = run.profile
    f = prof.mode("tracking") if prof is not None else None
    if f is None or f.frames == 0 or f.kernels == 0:
        return None
    return f.kernels / f.frames
