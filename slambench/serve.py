"""The served path: one camera in a closed loop. Each frame is handed over
once the previous frame's pose is on the host: its 8-bit image is
uploaded from pinned memory, converted, run through the tracker's step,
and its pose is copied to the host.

``serve`` runs the timed window. With ``trace`` the window drives the
step's two halves (``pre``, ``combine``) instead, with the device drained
around each call into a layer, and records those spans; from the mix's
``profile_start`` on, frames go through the fused step under
``torch.profiler``, each marked with the mode it entered in, until
``profile_frames`` of them entered in TRACKING (or ``PROFILE_CAP`` times
as many frames have run).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from slambench import program, reference

clock = time.perf_counter
#: the profiler window's frames at most, in multiples of ``profile_frames``
PROFILE_CAP = 3
MODE_NAMES = {program.MODE_EMPTY: "empty",
              program.MODE_INITIALIZING: "initializing",
              program.MODE_TRACKING: "tracking"}


class FrameBudgetExhausted(Exception):
    """The run needed more frames than its traffic mix renders."""


@dataclass
class Log:
    """What the window's frames gave, one entry per frame handed over."""

    entry_mode: list = field(default_factory=list)
    after_mode: list = field(default_factory=list)
    success: list = field(default_factory=list)
    raised: list = field(default_factory=list)
    poses: list = field(default_factory=list)        # (12,) R row-major, t
    latency_s: list = field(default_factory=list)
    # the state's own tensors after each frame (references, no copies)
    feats: list = field(default_factory=list)        # (lf_xy, lf_desc, lf_mask)
    maps: list = field(default_factory=list)         # (map_pos, map_valid)
    rank_maps: dict = field(default_factory=dict)    # frame -> K1's output
    spans: dict = field(default_factory=dict)        # name -> [seconds]
    first_error: str = ""
    cpu_s: float = 0.0          # the process's CPU time over the window
    start: float = 0.0
    end: float = 0.0

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    @property
    def frames(self) -> int:
        return len(self.latency_s)


class Session:
    """A tracker serving one camera's frames."""

    def __init__(self, cell, frames: torch.Tensor, seed: int, device):
        self.cell = cell
        self.traffic = cell.traffic
        self.frames = frames                 # (N, h, w) uint8, pinned
        self.seed = seed
        self.device = torch.device(device)
        self.trk = program.tracker(cell.config, cell.camera.K(), device)
        self.tap = program.K1Tap()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fresh(self):
        """A new tracker state, seeded from the run's seed."""
        return self.trk.init_state(self.seed)

    def image(self, i: int) -> torch.Tensor:
        if i >= self.frames.shape[0]:
            raise FrameBudgetExhausted(
                f"the traffic mix {self.traffic.name!r} renders "
                f"{self.frames.shape[0]} frames and the run needed more: "
                f"raise its 'frames' cap")
        return reference.to_image(self.frames[i].to(self.device,
                                                    non_blocking=True))

    @staticmethod
    def _host(out) -> np.ndarray:
        """The frame's pose and mode on the host."""
        host = torch.cat([out.pose_R.reshape(9), out.pose_t.reshape(3),
                          out.mode.reshape(1).to(out.pose_t.dtype)]).cpu()
        return host.numpy().astype(np.float64)

    def _frame(self, i, state, entry, log, trace):
        """One frame through the fused step (``trace`` False) or through
        its two halves with the device drained around each."""
        img = self.image(i)
        t = self.trk
        if not trace:
            state, out = t.step(state, img, t.K_inv, t.focal)
            return state, out, self._host(out)
        self._sync()
        t0 = clock()
        f, smooth = t.pre(img, t.K_inv, t.focal)
        self._sync()
        t1 = clock()
        state, out = t.combine(state, f, smooth, t.K_inv, t.focal)
        self._sync()
        t2 = clock()
        log.span("features.preprocess", t1 - t0)
        if entry == program.MODE_TRACKING:
            log.span("vo_jit.track", t2 - t1)
        elif entry == program.MODE_INITIALIZING:
            log.span("vo_jit.init", t2 - t1)
        return state, out, self._host(out)

    def warm_up(self) -> None:
        """Every branch the window takes, on a prefix of the frames whose
        state is then thrown away: bootstrap and tracking (the traced
        window's halves are the same code)."""
        tr = self.traffic
        log = Log()
        state = self.fresh()
        for i in range(tr.warmup_frames):
            state, _, _ = self._frame(i, state, None, log, False)
        self._sync()

    def serve(self, seconds: float, trace: bool, rank_sample: set,
              profiler=None) -> Log:
        """The timed window: frames from the first of the mix, handed over
        while less than ``seconds`` have passed since the window opened.
        With ``trace``, ``profiler.open()`` gives the context manager put
        around the profiler's frames, which run the fused step, and
        ``profiler.frame(mode)`` the one around each of them."""
        tr = self.traffic
        log = Log()
        state = self.fresh()
        entry = program.MODE_EMPTY
        prof_ctx = None
        prof_state = "before" if trace and profiler is not None else "done"
        prof_seen = prof_tracking = 0
        self.tap.install()
        self._sync()
        log.start = clock()
        cpu0 = time.process_time()
        try:
            i = 0
            while clock() - log.start < seconds:
                if prof_state == "before" and i >= tr.profile_start:
                    prof_ctx = profiler.open()
                    prof_ctx.__enter__()
                    prof_state = "open"
                in_prof = prof_state == "open"
                self.tap.want = i in rank_sample
                t0 = clock()
                try:
                    if in_prof:
                        with profiler.frame(MODE_NAMES[entry]):
                            state, out, host = self._frame(i, state, entry,
                                                           log, False)
                    else:
                        state, out, host = self._frame(i, state, entry, log,
                                                       trace)
                    ok = bool(out.success)
                    raised = False
                except torch.cuda.OutOfMemoryError:
                    raise
                except RuntimeError as e:          # a step that raised
                    if not log.first_error:
                        log.first_error = f"frame {i}: {e}"
                    state = self.fresh()
                    host = np.full(13, np.nan)
                    host[12] = program.MODE_EMPTY
                    ok, raised = False, True
                t1 = clock()
                if in_prof:
                    prof_seen += 1
                    prof_tracking += entry == program.MODE_TRACKING
                    if (prof_tracking >= tr.profile_frames
                            or prof_seen >= PROFILE_CAP * tr.profile_frames):
                        prof_ctx.__exit__(None, None, None)
                        prof_ctx = None
                        prof_state = "done"
                if self.tap.want and self.tap.got is not None:
                    log.rank_maps[i] = self.tap.got
                self.tap.got = None
                log.latency_s.append(t1 - t0)
                log.entry_mode.append(entry)
                log.after_mode.append(int(host[12]))
                log.success.append(ok)
                log.raised.append(raised)
                log.poses.append(host[:12])
                if not raised:
                    log.feats.append((state.lf_xy, state.lf_desc,
                                      state.lf_mask))
                    log.maps.append((state.map_pos, state.map_valid))
                else:
                    log.feats.append(None)
                    log.maps.append(None)
                entry = int(host[12])
                log.end = t1
                i += 1
            log.cpu_s = time.process_time() - cpu0
        finally:
            if prof_ctx is not None:
                prof_ctx.__exit__(None, None, None)
            self.tap.remove()
        return log
