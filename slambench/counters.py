"""The counters of the KITTI deployment's metrics, read in a pass of their
own after the traced window, once per run; nothing is added to the step
or to the served loop.

The pass: a fresh tracker (``stages.PASS_SEED``, as the stage pass) over
the run's frames from the first, through the step's op-by-op form
(``vo_jit._make_vo_step_fns(..., cuda_graphs=False)``, bit for bit the
graphed step on the card), until ``profile_frames`` frames that entered
in TRACKING have run from the mix's ``profile_start`` on (at most
``serve.PROFILE_CAP`` times as many frames). ``BATap`` keeps the problem
and the result of each frame's two-frame BA. On each of those TRACKING
frames:

- ``n_keypoints``: the keypoints the frame's feature half kept, counted
  in the state's ``lf_mask`` (every branch stores the frame's own
  features);
- ``ba_robust``: the share of the BA's valid observations whose whitened
  residual norm at its result exceeds the tracker's ``huber_delta``
  (``ops/ba.huber_share``); 0 without the delta or where no BA ran.

A counter the port cannot give (a state without ``lf_mask``, a BA module
without ``huber_share``) is left out, and with neither no pass is made.
"""

from __future__ import annotations

import contextlib
import weakref

import torch

from slambench import program, reference, serve, stages

FIELDS = ("n_keypoints", "ba_robust")


def _ba():
    """The BA module the port's step calls."""
    return getattr(program.vo_jit, "ba_mod", None)


def available(name: str) -> bool:
    """Whether the port gives the counter ``name``."""
    if name == "n_keypoints":
        return "lf_mask" in getattr(program.vo_jit.VoJitState, "_fields", ())
    if name == "ba_robust":
        return hasattr(_ba(), "huber_share")
    return False


class BATap:
    """The BA module as the tracker's step sees it (``vo_jit.ba_mod``),
    keeping the problem, the settings and the result of each ``ba_solve``
    the step makes itself (its two-frame BA; the solves inside PnP and the
    bootstrap go through their own modules' name)."""

    def __init__(self, ba):
        self._ba = ba
        self.solved = []

    def __getattr__(self, name):
        return getattr(self._ba, name)

    def ba_solve(self, prob, params, *args, **kwargs):
        res = self._ba.ba_solve(prob, params, *args, **kwargs)
        self.solved.append((prob, params, res))
        return res


@contextlib.contextmanager
def tapped():
    """A ``BATap`` put in the step's module while the block runs."""
    ba = _ba()
    tap = BATap(ba)
    program.vo_jit.ba_mod = tap
    try:
        yield tap
    finally:
        program.vo_jit.ba_mod = ba


def counter_pass(cell, frames, device) -> dict:
    """``FIELDS`` name -> its values (floats) on the pass's TRACKING frames
    over ``frames`` (the run's 8-bit frames) for ``cell``; the counters
    the port cannot give are left out."""
    kept = {name: [] for name in FIELDS if available(name)}
    if not kept:
        return {}
    trk = program.tracker(cell.config, cell.camera.K(), device)
    p = trk.params
    step, _, _ = program.vo_jit._make_vo_step_fns(p, cuda_graphs=False)
    tr = cell.traffic
    state, entry = trk.init_state(stages.PASS_SEED), program.MODE_EMPTY
    i = seen = n_tracking = 0
    with tapped() as tap:
        while i < frames.shape[0] and (
                i < tr.profile_start
                or (n_tracking < tr.profile_frames
                    and seen < serve.PROFILE_CAP * tr.profile_frames)):
            tap.solved.clear()
            img = reference.to_image(frames[i].to(trk.device))
            try:
                state, _ = step(state, img, trk.K_inv, trk.focal)
                after, ok = int(state.mode), True
            except torch.cuda.OutOfMemoryError:
                raise
            except RuntimeError:      # a step that raised: the loop resets
                state = trk.init_state(stages.PASS_SEED)
                after, ok = program.MODE_EMPTY, False
            if i >= tr.profile_start:
                seen += 1
                if entry == program.MODE_TRACKING:
                    n_tracking += 1
                    if ok:
                        _record(kept, state, tap, p.huber_delta)
            entry = after
            i += 1
    return {name: [float(t) for t in values]
            for name, values in kept.items()}


def _record(kept, state, tap, huber_delta) -> None:
    if "n_keypoints" in kept:
        kept["n_keypoints"].append(torch.sum(state.lf_mask))
    if "ba_robust" in kept:
        if tap.solved:
            prob, _, res = tap.solved[-1]
            share = tap.huber_share(res.poses, res.points, prob, huber_delta)
        else:
            share = 0.0
        kept["ba_robust"].append(share)


_read: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def tracking(run, name: str) -> list | None:
    """The counter ``name`` on the pass's TRACKING frames of ``run``
    (``run.Reading``), from one pass per run; ``None`` where the port
    cannot give the counter, the traced window gave no profile, or no
    frame of the pass entered in TRACKING."""
    if not available(name) or run.profile is None:
        return None
    if run not in _read:
        _read[run] = counter_pass(run.cell, run.frames, run.device)
    return _read[run].get(name) or None
