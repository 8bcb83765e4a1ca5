"""The profiler window's reduction on made-up events: kernels go to the
frame whose span holds their start, and each entering mode gets its own
frames, spans, busy time, launches and K1 times, so that a reset inside
the window leaves the tracking frames' readings alone."""

import pytest
import torch

from slambench import trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, start, end, device=CPU, act="kernel"):
        self._n, self._a, self._b = name, start, end
        self._d, self._act = device, act

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return self._d

    def start_thread_id(self):
        return 1

    def __getattr__(self, name):
        if name == "activity_type" and self._act:
            return lambda: "ActivityType." + self._act.upper()
        raise AttributeError(name)


def _kernel(name, a, b):
    return Event(name, a, b, CUDA)


def test_each_mode_keeps_its_own_frames():
    events = [
        Event(trace.WINDOW, 0, 1000),
        Event(trace.FRAME + "tracking", 0, 300),
        Event(trace.FRAME + "initializing", 300, 700),
        Event(trace.FRAME + "tracking", 700, 1000),
        Event("aten::mul", 10, 20),
        _kernel("mul_kernel", 20, 120),
        _kernel("fast_nms_harris_pyramid_kernel", 150, 160),
        _kernel("svd_kernel", 310, 610),
        _kernel("fast_nms_harris_pyramid_kernel", 320, 330),
        _kernel("mul_kernel", 720, 770),
        _kernel("fast_nms_harris_pyramid_kernel", 800, 814),
        # the markers, mirrored on the device with no activity type
        Event(trace.WINDOW, 0, 1000, CUDA, act=""),
        Event(trace.FRAME + "tracking", 0, 300, CUDA, act=""),
    ]
    p = trace.reduce(events, "fast_nms_harris")
    assert p.window_s == pytest.approx(1000e-9)
    assert p.busy_s == pytest.approx((100 + 10 + 300 + 50 + 14) * 1e-9)
    t, i = p.mode("tracking"), p.mode("initializing")
    assert (t.frames, i.frames) == (2, 1)
    assert t.span_s == pytest.approx(600e-9)
    assert t.busy_s == pytest.approx((100 + 10 + 50 + 14) * 1e-9)
    assert i.busy_s == pytest.approx(300e-9)
    assert (t.kernels, i.kernels) == (4, 2)
    assert t.k1_s == pytest.approx([10e-9, 14e-9])
    assert i.k1_s == pytest.approx([10e-9])
    assert p.mode("empty").frames == 0


def test_window_without_frames_reads_nothing_by_mode():
    p = trace.reduce([Event(trace.WINDOW, 0, 100), _kernel("k", 10, 20)],
                     "fast_nms_harris")
    assert p.by_mode == {}
    assert p.busy_s == pytest.approx(10e-9)
