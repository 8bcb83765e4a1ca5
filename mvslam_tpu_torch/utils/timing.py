"""Timing: the host's monotonic clock (a copy of
``mvslam_tpu.utils.timing``'s), spans for the profiler's trace, and timing
on the card: eager time and device time of a launch, and where a piece of
code synchronises with the device.

``get_time_ms``/``get_time_us`` count from the module's import. ``span``
marks a stage of the program in ``torch.profiler``'s trace while a profiler
records, and costs one check otherwise. The card's
helpers need a CUDA device and raise without one. ``cuda_ms`` times
``fn`` as the host issues it (Python, allocator and launch included, so a
short kernel shows the host's issue rate). ``graph_ms`` captures ``fn``
in a CUDA graph and replays it, so the host is out of the loop (but for
the replay call itself) and what remains is the device time of ``fn``'s
launches. The capture also
proves that ``fn`` launches on torch's current stream and synchronises
nothing: anything else fails the capture. ``sync_sites`` runs ``fn`` under
torch's sync debug mode and returns the source line of every synchronising
call it made (a read of a device value, an upload from pageable memory).
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from typing import Callable

import torch

_START = time.monotonic()


def get_time_ms() -> int:
    """Milliseconds since process start (reference ``os/time.cpp:10-33``)."""
    return int((time.monotonic() - _START) * 1e3)


def get_time_us() -> int:
    """Microseconds since process start."""
    return int((time.monotonic() - _START) * 1e6)


def sleep_ms(ms: float) -> None:
    time.sleep(ms / 1e3)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that marks a stage named ``name``. While a
    ``torch.profiler`` records, it is a record function of the profiler's
    own op kind (``_RecordFunctionFast``): a host op in the trace, on the
    calling thread, on the clock the profiler gives the device's events,
    inside the span that encloses it there. ``record_function``'s user
    annotations are not used: the profiler mirrors them on the device's
    timeline, where a torch that gives its events no activity type cannot
    tell them from kernels. Otherwise the span is one shared null context,
    which adds no work to the stage."""
    if torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def _between_events(fn: Callable[[], object], reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cuda_ms(fn: Callable[[], object], reps: int = 50, warmup: int = 5) -> float:
    """Milliseconds per eager call of ``fn``, CUDA events around ``reps``
    calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return _between_events(fn, reps)


def graph_ms(fn: Callable[[], object], reps: int = 50, warmup: int = 5,
             calls: int = 1) -> float:
    """Milliseconds per call of ``fn`` in a CUDA graph that holds ``calls``
    of them in a row, CUDA events around ``reps`` replays after ``warmup``.
    With one call a replay's own cost on the host can exceed a short
    kernel's time; with many, the calls run back to back on the device."""
    fn()                                   # build, load and cache before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kept = [fn() for _ in range(calls)]   # outputs live as long as the graph
    for _ in range(warmup):
        graph.replay()
    torch.cuda.synchronize()
    ms = _between_events(graph.replay, reps) / calls
    del kept
    return ms


def sync_sites(fn: Callable[[], object]) -> tuple[object, list[str]]:
    """``fn()`` with every synchronising CUDA call recorded (torch's sync
    debug mode warns on each): (result, ["file.py:line", ...])."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.basename(w.filename)}:{w.lineno}"
                 for w in caught if "synchroniz" in str(w.message)]
