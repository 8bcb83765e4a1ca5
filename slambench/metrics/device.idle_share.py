"""``device.idle_share``: 1 minus the device's busy time (the union of its
kernel, copy and fill intervals) over the host spans of the traced run's
profiled frames that entered in TRACKING (frames through the fused
step), in percent."""

LAYER = "device"
UNIT = "%"
MOVES = "frames_per_s"


def read(run):
    prof = run.profile
    f = prof.mode("tracking") if prof is not None else None
    if f is None or f.frames == 0 or f.span_s <= 0:
        return None
    return 100.0 * (1.0 - f.busy_s / f.span_s)
