"""The rotation path on the port: ``tests/test_rotation.py`` (the oracle of
the tracker's rotation estimates) rerun on
``mvslam_tpu_torch.frontend.vo_jit``.

40 frames of the two-plane scene (240x320, focal 280, slanted background)
with the camera yawing ``0.06 sin(0.3 i)`` while it translates, rendered by
``utils/scene.render_planes_sequence`` (exact yaw ground truth), through
``make_vo_step`` at the default ``VoJitParams()``. The reference's bars:
at least 36 of 40 frames tracked, the longest tracked segment at least 24
frames with a yaw swing of at least 0.08 rad inside it, and per segment of
6 frames or more a yaw residual (after the segment's gauge offset) under
0.01 rad and a regression slope in (0.93, 1.07).

Then the port against the JAX tracker frame by frame over the first 12
frames, from one state and under JAX's own RANSAC draws, as
``tests/test_torch_vo.py`` feeds them: modes, success and rotations within
that file's ``R_ATOL`` on the port's own run; translations within its
``T_ATOL`` one step at a time from the JAX tracker's state, except at the
bootstrap frame, whose float32 sensitivity is inherited from the reference
(``INHERITED_BOOTSTRAP``).

| reference case | | where |
|---|---|---|
| `test_rotation.py::test_rotation_sequence_tracks` | a | `test_rotation_sequence_tracks` |
| `test_rotation.py::test_yaw_recovered_per_segment` | a | `test_yaw_recovered_per_segment` |
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.frontend import vo_jit as jv
from mvslam_tpu_torch.convert import state_from_numpy
from mvslam_tpu_torch.frontend import vo_jit as tv
from mvslam_tpu_torch.utils.scene import render_planes_sequence

from test_torch_vo import R_ATOL, T_ATOL, _jax_draws
from test_torch_ref_common import one_torch_thread  # noqa: F401 (autouse)

H, W = 240, 320
FOCAL = 280.0
N_FRAMES = 40
N_LOCKSTEP = 12


def yaw_sequence():
    """The reference's scene: frames, true yaws, K^-1."""
    i = np.arange(N_FRAMES)
    ts = np.stack([i * 0.12, 0.02 * np.sin(i * 0.25), np.zeros(N_FRAMES)], 1)
    yaws = 0.06 * np.sin(i * 0.3)
    frames = render_planes_sequence(ts, h=H, w=W, focal=FOCAL, bg_slope=0.18,
                                    yaws=yaws)
    K_inv = np.linalg.inv(np.asarray(
        [[FOCAL, 0, (W - 1) / 2.0], [0, FOCAL, (H - 1) / 2.0], [0, 0, 1]]))
    return frames, yaws, K_inv


def yaw_of(R) -> float:
    """Yaw of an R_y rotation: R[0, 2] = sin, R[2, 2] = cos."""
    R = np.asarray(R)
    return float(np.arctan2(R[0, 2], R[2, 2]))


def segments(oks):
    """Contiguous tracked runs as (start, end) frame ranges."""
    segs, start = [], None
    for k, o in enumerate(oks):
        if o and start is None:
            start = k
        if not o and start is not None:
            segs.append((start, k))
            start = None
    if start is not None:
        segs.append((start, len(oks)))
    return segs


@pytest.fixture(scope="module")
def scene():
    return yaw_sequence()


@pytest.fixture(scope="module")
def yaw_run(scene):
    """The port's tracker over the 40 frames with its own generator."""
    frames, yaws, K_inv = scene
    params = tv.VoJitParams()
    step = tv.make_vo_step(params)
    state = tv.vo_init_state(params, device="cpu")
    K = torch.tensor(K_inv, dtype=torch.float32)
    focal = torch.tensor(FOCAL, dtype=torch.float32)
    oks, yest = [], []
    for frame in frames:
        state, out = step(state, torch.from_numpy(frame), K, focal)
        oks.append(bool(out.success))
        yest.append(yaw_of(out.pose_R.numpy()))
    return yaws, np.asarray(oks), np.asarray(yest)


def test_rotation_sequence_tracks(yaw_run):
    yaws, oks, _ = yaw_run
    n = len(oks)
    assert oks.sum() >= int(0.9 * n), f"tracked {oks.sum()}/{n}"
    a, b = max(segments(oks), key=lambda s: s[1] - s[0])
    assert b - a >= int(0.6 * n)
    assert yaws[a:b].max() - yaws[a:b].min() >= 0.08


def test_yaw_recovered_per_segment(yaw_run):
    yaws, oks, yest = yaw_run
    checked = 0
    for a, b in segments(oks):
        if b - a < 6:
            continue
        sel = np.arange(a, b)
        resid = yest[sel] - yaws[sel]
        r = resid - np.median(resid)
        assert np.abs(r).max() < 0.01, (a, b, float(np.abs(r).max()))
        A = np.vstack([yaws[sel], np.ones(len(sel))]).T
        slope = float(np.linalg.lstsq(A, yest[sel], rcond=None)[0][0])
        assert 0.93 < slope < 1.07, (a, b, slope)
        checked += 1
    assert checked >= 1


def test_the_smoke_run_holds_the_same_bars(scene, yaw_run):
    """``chip_smoke.py``'s reference-bars phase replays this scene on the
    card and holds it to these bars with its own code."""
    import chip_smoke as cs

    yaws, oks, yest = yaw_run
    assert (cs.ROT_FRAMES, cs.ROT_MIN_TRACKED, cs.ROT_MIN_SEGMENT) == (
        N_FRAMES, int(0.9 * N_FRAMES), int(0.6 * N_FRAMES))
    assert (cs.ROT_MIN_SWING, cs.ROT_MIN_CHECKED, cs.ROT_MAX_RESID,
            cs.ROT_SLOPE) == (0.08, 6, 0.01, (0.93, 1.07))
    frames, smoke_yaws = cs.rotation_scene()
    np.testing.assert_array_equal(frames, scene[0])
    np.testing.assert_array_equal(smoke_yaws, yaws)
    assert cs.tracked_segments(oks) == segments(oks)
    bars = cs.rotation_bars(oks, yest, yaws, "the port on the CPU")
    assert bars["tracked"] == int(oks.sum())


@pytest.fixture(scope="module")
def lockstep(scene):
    """Both trackers over the first 12 frames from one state, the port fed
    the uniforms the JAX step draws from its key: the port's own run
    (``free``) and one step at a time from the JAX tracker's state before
    each frame (``carried``)."""
    frames, _, K_inv = scene
    jp, tp = jv.VoJitParams(), tv.VoJitParams()
    jstep, tstep = jv.make_vo_step(jp), tv.make_vo_step(tp)
    js = jv.vo_init_state(jp)

    def port_state(s):
        return state_from_numpy(
            {k: np.asarray(v) for k, v in s._asdict().items() if k != "key"},
            device="cpu")

    free = port_state(js)
    jK, jf = jnp.asarray(K_inv, jnp.float32), jnp.asarray(FOCAL, jnp.float32)
    tK = torch.tensor(K_inv, dtype=torch.float32)
    tf = torch.tensor(FOCAL, dtype=torch.float32)
    outs = {"jax": [], "free": [], "carried": []}
    for frame in frames[:N_LOCKSTEP]:
        draws = _jax_draws(js, jp)
        draws = None if draws is None else torch.tensor(draws)
        image = torch.from_numpy(frame)
        _, carried = tstep(port_state(js), image, tK, tf, draws)
        free, to = tstep(free, image, tK, tf, draws)
        js, jo = jstep(js, jnp.asarray(frame), jK, jf)
        outs["jax"].append(jax.tree_util.tree_map(np.asarray, jo))
        outs["free"].append(to)
        outs["carried"].append(carried)
    return outs


def test_modes_and_success_match_the_jax_tracker(lockstep):
    jm = [(int(o.mode), bool(o.success)) for o in lockstep["jax"]]
    for run in ("free", "carried"):
        assert [(int(o.mode), bool(o.success)) for o in lockstep[run]] == jm
    # the window covers the bootstrap, tracked rotating frames, a reset
    # and a re-bootstrap
    assert sum(s for _, s in jm) >= 10, jm


def test_rotations_match_the_jax_tracker(lockstep):
    for run in ("free", "carried"):
        for k, (jo, to) in enumerate(zip(lockstep["jax"], lockstep[run])):
            np.testing.assert_allclose(to.pose_R.numpy(), jo.pose_R, rtol=0,
                                       atol=R_ATOL, err_msg=f"{run} {k}")


#: the bootstrap at frame 1 (ROADMAP Queue 3, "Inherited"): on this
#: 0.12-unit baseline with a 0.018 rad yaw the float32 eigh refit of the
#: essential matrix lies 8e-2 from the float64 one in both packages, and
#: one consensus ray sits on the RANSAC threshold, so summation order
#: alone moves the refined translation direction: the JAX package's own
#: op-by-op chain and its compiled step differ there by 5.5e-4 (179 vs 180
#: inliers), the port and the compiled step by 5.7e-4. Every later step,
#: from the same state, is within T_ATOL.
INHERITED_BOOTSTRAP = {1: 1e-3}


def test_translations_match_the_jax_tracker_step_by_step(lockstep):
    for k, (jo, to) in enumerate(zip(lockstep["jax"], lockstep["carried"])):
        np.testing.assert_allclose(
            to.pose_t.numpy(), jo.pose_t, rtol=0,
            atol=INHERITED_BOOTSTRAP.get(k, T_ATOL), err_msg=f"frame {k}")
