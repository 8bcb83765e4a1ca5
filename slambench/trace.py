"""The traced run's profiler window: ``torch.profiler`` (CPU and CUDA
activity) around a run of frames, each marked with the mode the tracker
entered it in. It is reduced to the device's busy time over the whole
window, the breakdown the result line carries (device operations by
time, idle time by what the host was doing), and, for each entering
mode, the frames' span, the device's busy time within it, its kernel
launches and K1's kernel times, so that a reset inside the window does
not mix bootstrap frames into the tracking frames' readings."""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "slambench.profiled_frames"
FRAME = "slambench.frame."          # + the mode the frame entered in
TOP = 10
NAME_CHARS = 160          # a kernel's name in the breakdown, cut to this


@dataclass
class Frames:
    """The profiled frames that entered in one mode."""

    frames: int = 0
    span_s: float = 0.0         # the frames' spans on the host, summed
    busy_s: float = 0.0         # device busy inside those spans
    kernels: int = 0
    k1_s: list = field(default_factory=list)


@dataclass
class Profile:
    """What one profiler window read."""

    window_s: float = 0.0
    busy_s: float = 0.0
    by_mode: dict = field(default_factory=dict)      # mode -> Frames
    device_ops: list = field(default_factory=list)   # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)    # [[host op, seconds]]

    def mode(self, name: str) -> Frames:
        return self.by_mode.get(name, Frames())


class Profiler:
    """``open()`` gives the context manager the served loop puts around
    its profiler frames, ``frame(mode)`` the one around each of them;
    ``result()`` reduces what it recorded, after the window."""

    def __init__(self, k1_kernel: str, cuda: bool):
        self.k1_kernel = k1_kernel
        self.cuda = cuda
        self._prof = None

    @contextlib.contextmanager
    def open(self):
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                yield
                if self.cuda:
                    torch.cuda.synchronize()
        self._prof = prof

    @staticmethod
    def frame(mode: str):
        return record_function(FRAME + mode)

    def result(self) -> Profile | None:
        """The window's profile, or ``None`` where the run ended before
        the profiler frames."""
        if self._prof is None:
            return None
        return reduce(self._prof.profiler.kineto_results.events(),
                      self.k1_kernel)


def _activity(e) -> str:
    """The event's kind in lower case (``kernel``, ``gpu_memcpy``, ...),
    whichever way this torch spells it; ``""`` where it gives none."""
    if not hasattr(e, "activity_type"):
        return ""
    return str(e.activity_type()).rsplit(".", 1)[-1].lower()


def _device_work(act: str, name: str) -> bool:
    """A kernel, copy or fill: not an annotation mirrored on the device (the
    harness's own markers by name, whatever activity this torch gives
    them)."""
    if name == WINDOW or name.startswith(FRAME) or "annotation" in act:
        return False
    return not act or any(k in act for k in ("kernel", "memcpy", "memset"))


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _innermost(cpu, points):
    """For each point (sorted), the name of the innermost host event of
    ``cpu`` (properly nested (start, end, name), sorted by start) that
    holds it, or ``None``."""
    names, stack, j = [], [], 0
    for m in points:
        while j < len(cpu) and cpu[j][0] <= m:
            while stack and stack[-1][1] <= cpu[j][0]:
                stack.pop()
            stack.append(cpu[j])
            j += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        names.append(stack[-1][2] if stack else None)
    return names


def _clipped_busy(busy, spans) -> float:
    """Seconds of the merged intervals ``busy`` inside the sorted, disjoint
    ``spans``."""
    total, j = 0, 0
    for a, b in spans:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            total += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
    return total * 1e-9


def reduce(events, k1_kernel: str) -> Profile:
    """The profile of the span named ``WINDOW`` in kineto's ``events``."""
    win = [e for e in events if e.name() == WINDOW
           and e.device_type() == torch.autograd.DeviceType.CPU]
    if not win:
        raise RuntimeError(f"no {WINDOW!r} span in the profile")
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    thread = win[0].start_thread_id()
    dev, cpu, frames = [], [], []
    by_name = defaultdict(int)
    kernels = []                # (start, is K1, seconds)
    for e in events:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if b <= w0 or a >= w1:
            continue
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.start_thread_id() != thread or e.name() == WINDOW:
                continue
            if e.name().startswith(FRAME):
                frames.append((a, b, e.name()[len(FRAME):]))
            else:
                cpu.append((a, b, e.name()))
            continue
        act = _activity(e)
        if not _device_work(act, e.name()):
            continue
        a, b = max(a, w0), min(b, w1)
        dev.append((a, b))
        by_name[e.name()] += b - a
        if "kernel" in act or not act:
            kernels.append((a, k1_kernel in e.name(), e.duration_ns() * 1e-9))
    busy = _union(dev)
    gaps = []
    prev = w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    cpu.sort()
    idle = defaultdict(int)
    for (a, b), name in zip(gaps, _innermost(cpu, [(a + b) // 2
                                                   for a, b in gaps])):
        idle[name or "host (no op)"] += b - a
    # each kernel to the frame whose span holds its start: the closed loop
    # drains the device at the end of every frame
    frames.sort()
    starts = [a for a, _, _ in frames]
    by_mode = defaultdict(Frames)
    spans = defaultdict(list)
    for a, b, mode in frames:
        f = by_mode[mode]
        f.frames += 1
        f.span_s += (b - a) * 1e-9
        spans[mode].append((a, b))
    for a, is_k1, seconds in kernels:
        j = bisect.bisect_right(starts, a) - 1
        if j < 0 or a >= frames[j][1]:
            continue
        f = by_mode[frames[j][2]]
        f.kernels += 1
        if is_k1:
            f.k1_s.append(seconds)
    for mode, sp in spans.items():
        by_mode[mode].busy_s = _clipped_busy(busy, sp)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Profile(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(b - a for a, b in busy) * 1e-9, by_mode=dict(by_mode),
        device_ops=[[n[:NAME_CHARS], ns * 1e-9] for n, ns in top],
        idle_gaps=[[n[:NAME_CHARS], ns * 1e-9] for n, ns in top_idle])
