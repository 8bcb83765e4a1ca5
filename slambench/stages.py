"""The tracker step's stages, read from a profiled pass of the traced run.

The port marks the stages of its step with spans (``vo_jit.SPANS``: host
ops in ``torch.profiler``'s trace while it records, nothing otherwise).
The traced window's own reduction (``trace.reduce``) keeps none of its
events, so the stage metrics make a pass of their own after the window,
once per run: a fresh tracker (``PASS_SEED``) over the run's frames from
the first, with the profiler around the frames the window profiles (from
the mix's ``profile_start`` until ``profile_frames`` of them entered in
TRACKING, at most ``serve.PROFILE_CAP`` times as many), each through the
fused step and marked with its entering mode as the served loop marks it.

``reduce`` puts down to each program span, by entering mode and per
frame:

- host time (the span's duration, summed over its calls in the frame),
  and self time (less what its child spans cover);
- launches: each device event (kernel, copy or fill) goes to the spans
  that hold its launch on the host, the CUDA API call (``cuda...`` or
  ``cu...``) with the event's correlation id, not to those that hold its
  start on the device. A span's launches include its children's;
- device busy: the union of the intervals of the events so put down;
- host reads: the synchronising calls in the span (``SYNC_CALLS``) and
  the host's wait in them. A read of a device value is a copy then a
  ``cudaStreamSynchronize``; into pageable memory the copy call itself
  blocks, so its time is wait too (one read, not two).

Device events whose launch call is not in the trace are put down by their
start on the device and counted in ``unlinked``. Those launched in a frame
that start on the device outside it are counted in ``crossed``: the
profiler puts the device's clock on the host's to within some hundred
microseconds, so a count by device start (``trace.reduce``'s) can miss
them. Annotations mirrored on the device are not device events: the
harness's markers and the program's spans are left out by name (the
card's torch gives them no activity type). ``idle_by_span`` puts
each idle gap of the pass's window down to the innermost program span
that holds its midpoint, host ops of torch left out; a gap in none goes to
``OUTSIDE`` (the harness's upload and pose copy, and between frames).

On the H100 with torch 2.11 (CUDA 12.8) the trace's events carry no
activity type; its runtime calls are ``cudaLaunchKernel``,
``cudaLaunchKernelExC``, ``cuLaunchKernel``, ``cudaMemcpyAsync`` and
``cudaMemsetAsync`` (one per device event), and its synchronising calls
``cudaStreamSynchronize`` (each read) and ``cudaDeviceSynchronize`` (the
window's end).
"""

from __future__ import annotations

import bisect
import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from slambench import program, serve, stats, trace

#: the port's span names; empty for a port whose step has no spans
SPANS = tuple(getattr(program.vo_jit, "SPANS", ()))
#: the tracker's seed in the pass
PASS_SEED = 0
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
OUTSIDE = "outside the program"


@dataclass
class Stage:
    """One span in the frames of one entering mode: one entry per frame
    that ran it."""

    host_s: list = field(default_factory=list)
    self_s: list = field(default_factory=list)
    busy_s: list = field(default_factory=list)
    launches: list = field(default_factory=list)
    reads: list = field(default_factory=list)
    wait_s: list = field(default_factory=list)


@dataclass
class Stages:
    """What the pass read."""

    frames: dict = field(default_factory=dict)     # mode -> frames
    by_mode: dict = field(default_factory=dict)    # mode -> {span: Stage}
    # mode -> device events that started in the frames (the count behind
    # ``device.launches_per_frame``); launches in no program span; device
    # events launched in a frame that started outside it on the device
    kernels: dict = field(default_factory=dict)
    outside: dict = field(default_factory=dict)
    crossed: dict = field(default_factory=dict)
    unlinked: int = 0
    idle_by_span: list = field(default_factory=list)   # [[span, seconds]]

    def stage(self, mode: str, name: str) -> Stage | None:
        return self.by_mode.get(mode, {}).get(name)


def _runtime(name: str) -> bool:
    """A call of CUDA's runtime API (``cuda...``) or its lower-level API
    (``cuX...``)."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def _chains(marks, points):
    """For each point (sorted), the indices of the marks (properly nested
    (start, end, name), sorted by start and then by longest) that hold it,
    outermost first."""
    out, stack, j = [], [], 0
    for m in points:
        while j < len(marks) and marks[j][0] <= m:
            while stack and marks[stack[-1]][1] <= marks[j][0]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and marks[stack[-1]][1] < m:
            stack.pop()
        out.append(tuple(stack))
    return out


def reduce(events, spans=SPANS) -> Stages:
    """The stages of the span named ``trace.WINDOW`` in kineto's
    ``events``."""
    spans = frozenset(spans)
    win = [e for e in events if e.name() == trace.WINDOW
           and e.device_type() == torch.autograd.DeviceType.CPU]
    if not win:
        raise RuntimeError(f"no {trace.WINDOW!r} span in the profile")
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    thread = win[0].start_thread_id()
    frames, marks, syncs = [], [], []
    launch_at, copies, dev = {}, {}, []
    for e in events:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if b <= w0 or a >= w1:
            continue
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.start_thread_id() != thread:
                continue
            if name.startswith(trace.FRAME):
                frames.append((a, b, name[len(trace.FRAME):]))
            elif name in spans:
                marks.append((a, b, name))
            elif _runtime(name):
                launch_at[e.correlation_id()] = a
                if name in SYNC_CALLS:
                    syncs.append((a, b, True))
                elif name.startswith("cudaMemcpy"):
                    copies[e.correlation_id()] = (a, b)
            continue
        if (name == trace.WINDOW or name.startswith(trace.FRAME)
                or name in spans):
            continue            # annotations mirrored on the device
        dev.append((max(a, w0), min(b, w1), e.correlation_id(), name))
    for a, b, corr, name in dev:
        if "DtoH" in name and "Pageable" in name and corr in copies:
            syncs.append(copies[corr] + (False,))
    frames.sort()
    marks.sort(key=lambda m: (m[0], -m[1]))
    starts = [a for a, _, _ in frames]

    def frame_of(t):
        j = bisect.bisect_right(starts, t) - 1
        return j if j >= 0 and t < frames[j][1] else None

    # per (frame, span): host, covered by children, launches, intervals,
    # reads, wait
    acc = defaultdict(lambda: [0, 0, 0, [], 0, 0])
    stack = []
    for k, (a, b, name) in enumerate(marks):
        while stack and marks[stack[-1]][1] <= a:
            stack.pop()
        j = frame_of(a)
        if j is not None:
            acc[j, name][0] += b - a
            if stack:
                acc[j, marks[stack[-1]][2]][1] += b - a
        stack.append(k)
    out = Stages()
    for _, _, mode in frames:
        out.frames[mode] = out.frames.get(mode, 0) + 1
        out.kernels.setdefault(mode, 0)
        out.outside.setdefault(mode, 0)
        out.crossed.setdefault(mode, 0)
    launches = []
    for a, b, corr, _ in dev:
        t = launch_at.get(corr)
        if t is None:
            out.unlinked += 1
            t = a
        launches.append((t, a, b))
        j = frame_of(a)
        if j is not None:
            out.kernels[frames[j][2]] += 1
    launches.sort()
    for (t, a, b), chain in zip(launches,
                                _chains(marks, [t for t, _, _ in launches])):
        j = frame_of(t)
        if j is None:
            continue
        if not chain:
            out.outside[frames[j][2]] += 1
        if frame_of(a) != j:
            out.crossed[frames[j][2]] += 1
        for k in chain:
            cell = acc[j, marks[k][2]]
            cell[2] += 1
            cell[3].append((a, b))
    syncs.sort()
    for (a, b, read), chain in zip(syncs,
                                   _chains(marks, [a for a, _, _ in syncs])):
        j = frame_of(a)
        if j is None:
            continue
        for k in chain:
            cell = acc[j, marks[k][2]]
            cell[4] += read
            cell[5] += b - a
    for (j, name), (host, covered, n, iv, reads, wait) in sorted(acc.items()):
        s = out.by_mode.setdefault(frames[j][2], {}).setdefault(name, Stage())
        s.host_s.append(host * 1e-9)
        s.self_s.append((host - covered) * 1e-9)
        s.launches.append(n)
        s.busy_s.append(sum(y - x for x, y in trace._union(iv)) * 1e-9)
        s.reads.append(reads)
        s.wait_s.append(wait * 1e-9)
    busy = trace._union([(a, b) for a, b, _, _ in dev])
    gaps, prev = [], w0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    idle = defaultdict(int)
    for (a, b), chain in zip(gaps, _chains(marks, [(a + b) // 2
                                                  for a, b in gaps])):
        idle[marks[chain[-1]][2] if chain else OUTSIDE] += b - a
    top = sorted(idle.items(), key=lambda kv: -kv[1])[:trace.TOP]
    out.idle_by_span = [[n, ns * 1e-9] for n, ns in top]
    return out


def profiled_pass(cell, frames, device):
    """Kineto's events of the pass over ``frames`` (the run's 8-bit
    frames) for ``cell``."""
    session = serve.Session(cell, frames, PASS_SEED, device)
    tr = cell.traffic
    cuda = session.device.type == "cuda"
    log = serve.Log()

    def step(i, state, entry):
        try:
            state, _, host = session._frame(i, state, entry, log, False)
            return state, int(host[12])
        except torch.cuda.OutOfMemoryError:
            raise
        except RuntimeError:          # a step that raised: the loop resets
            return session.fresh(), program.MODE_EMPTY

    state, entry = session.fresh(), program.MODE_EMPTY
    for i in range(tr.profile_start):
        state, entry = step(i, state, entry)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    seen = n_tracking = 0
    with profile(activities=activities) as prof:
        with record_function(trace.WINDOW):
            while (n_tracking < tr.profile_frames
                   and seen < serve.PROFILE_CAP * tr.profile_frames):
                n_tracking += entry == program.MODE_TRACKING
                with record_function(trace.FRAME + serve.MODE_NAMES[entry]):
                    state, entry = step(tr.profile_start + seen, state, entry)
                seen += 1
            if cuda:
                torch.cuda.synchronize()
    return prof.profiler.kineto_results.events()


def table(st: Stages) -> list[str]:
    """The stage table, one line per mode and span, then the launch check
    and the idle time by span."""
    med = stats.median
    lines = ["stages: mode span frames host_ms self_ms busy_ms "
             "launches/frame reads/frame wait_ms"]
    for mode, by in st.by_mode.items():
        for name in SPANS:
            s = by.get(name)
            if s is None:
                continue
            n = len(s.host_s)
            lines.append(
                f"stages: {mode} {name} {n} {1e3 * med(s.host_s):.3f} "
                f"{1e3 * med(s.self_s):.3f} {1e3 * med(s.busy_s):.3f} "
                f"{sum(s.launches) / n:.1f} {sum(s.reads) / n:.2f} "
                f"{1e3 * med(s.wait_s):.4f}")
        top = sum(sum(by[k].launches) for k in ("vo_jit.pre",
                                                 "vo_jit.combine") if k in by)
        lines.append(
            f"stages: {mode} launches: {st.kernels[mode]} device events "
            f"started in {st.frames[mode]} frames; launched in them: pre + "
            f"combine {top} + outside the program {st.outside[mode]}, "
            f"{st.crossed[mode]} of which started outside their frame")
    lines.append(f"stages: device events with no launch call: {st.unlinked}")
    lines.append("stages: idle by span: " + ", ".join(
        f"{n} {s:.6f} s" for n, s in st.idle_by_span))
    return lines


_read: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def of(run) -> Stages | None:
    """The stages of ``run`` (``run.Reading``), from one pass per run;
    ``None`` where the port has no spans or the traced window gave no
    profile. The table goes to standard error when the pass is made."""
    if not SPANS or run.profile is None:
        return None
    if run not in _read:
        st = reduce(profiled_pass(run.cell, run.frames, run.device))
        print("\n".join(table(st)), file=sys.stderr, flush=True)
        _read[run] = st
    return _read[run]


def tracking(run, name: str):
    """The span ``name`` in the pass's frames that entered in TRACKING, or
    ``None``."""
    st = of(run)
    return st.stage("tracking", name) if st is not None else None
