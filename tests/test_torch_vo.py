"""The PyTorch port's fused tracker against the JAX tracker, frame by frame.

8 frames of the two-plane scene (240x320, focal 280, slanted background)
with frame 4 blanked: the run goes EMPTY -> INITIALIZING (bootstrap) ->
TRACKING -> reset on the blank -> INITIALIZING (no partner yet) ->
re-bootstrap -> TRACKING. Both trackers start from one state (the port's
is ``state_from_numpy`` of the JAX one); before every step the RANSAC
uniforms the JAX tracker will draw from ``state.key`` are rebuilt exactly
as ``vo_jit.py`` / ``ransac.py`` draw them and handed to the port as
``draws``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.frontend import vo_jit as jv
from mvslam_tpu_torch.convert import state_from_numpy, state_to_numpy
from mvslam_tpu_torch.frontend import vo_jit as tv
from mvslam_tpu_torch.utils.scene import render_planes_sequence

H, W, FOCAL = 240, 320, 280.0
N_FRAMES = 8
BLANK = 4
#: float32 pose tolerance: the two packages sum in different orders
#: (cumsum box filters, matmul reductions), which drifts Harris ranks and
#: LM iterates by ~1e-6 relative; measured max |dt| 5e-5 and |dR| 1.4e-6
T_ATOL = 5e-4
R_ATOL = 5e-5


def _jax_draws(state, params):
    """The uniforms the JAX step will draw from ``state.key``."""
    K = params.orb.max_features
    mode = int(state.mode)
    _, k1 = jax.random.split(state.key)
    if mode == jv.MODE_INITIALIZING:
        keys = jax.random.split(k1, params.init_window)
        return np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (params.ransac_hypotheses, K))
        )(keys))
    if mode == jv.MODE_TRACKING:
        return np.asarray(jax.random.uniform(k1, (params.pnp_hypotheses, K)))
    return None


@pytest.fixture(scope="module")
def runs():
    n = N_FRAMES
    i = np.arange(n)
    ts = np.stack([i * 0.12, 0.02 * np.sin(i * 0.25), np.zeros(n)], 1)
    frames = render_planes_sequence(ts, h=H, w=W, focal=FOCAL, bg_slope=0.18)
    frames[BLANK] = 0.0
    K_inv = np.linalg.inv(np.asarray(
        [[FOCAL, 0, (W - 1) / 2], [0, FOCAL, (H - 1) / 2], [0, 0, 1]]))

    jp, tp = jv.VoJitParams(), tv.VoJitParams()
    jstep, tstep = jv.make_vo_step(jp), tv.make_vo_step(tp)
    js = jv.vo_init_state(jp)
    tstate = state_from_numpy(
        {k: np.asarray(v) for k, v in js._asdict().items() if k != "key"})
    jK, jf = jnp.asarray(K_inv, jnp.float32), jnp.asarray(FOCAL, jnp.float32)
    tK = torch.tensor(K_inv, dtype=torch.float32)
    tf = torch.tensor(FOCAL, dtype=torch.float32)
    j_outs, t_outs = [], []
    for k in range(n):
        draws = _jax_draws(js, jp)
        js, jo = jstep(js, jnp.asarray(frames[k]), jK, jf)
        tstate, to = tstep(tstate, torch.from_numpy(frames[k]), tK, tf,
                           None if draws is None else torch.tensor(draws))
        j_outs.append(jax.tree_util.tree_map(np.asarray, jo))
        t_outs.append(to)
    return j_outs, t_outs, js, tstate


def test_modes_match_frame_by_frame(runs):
    j_outs, t_outs, _, _ = runs
    jm = [int(o.mode) for o in j_outs]
    assert [int(o.mode) for o in t_outs] == jm
    # the scenario covers bootstrap, tracking, reset and re-bootstrap
    assert jm == [1, 2, 2, 2, 1, 1, 2, 2], jm


def test_success_matches_frame_by_frame(runs):
    j_outs, t_outs, _, _ = runs
    assert [bool(o.success) for o in t_outs] == [bool(o.success)
                                                 for o in j_outs]


def test_poses_match_frame_by_frame(runs):
    j_outs, t_outs, _, _ = runs
    for k, (jo, to) in enumerate(zip(j_outs, t_outs)):
        np.testing.assert_allclose(to.pose_t.numpy(), jo.pose_t, rtol=0,
                                   atol=T_ATOL, err_msg=f"frame {k}")
        np.testing.assert_allclose(to.pose_R.numpy(), jo.pose_R, rtol=0,
                                   atol=R_ATOL, err_msg=f"frame {k}")


def test_step_diagnostics_match(runs):
    j_outs, t_outs, _, _ = runs
    for jo, to in zip(j_outs, t_outs):
        assert int(to.init_tried) == int(jo.init_tried)
        # PnP inlier counts can differ by a boundary point or two
        assert abs(int(to.num_inliers) - int(jo.num_inliers)) <= 2


def test_final_state_bookkeeping_matches(runs):
    _, _, js, tstate = runs
    tn = state_to_numpy(tstate)
    for name in ("mode", "step", "frame_total", "frame_tracked", "rb_valid",
                 "rb_step", "rb_pos"):
        np.testing.assert_array_equal(tn[name], np.asarray(getattr(js, name)),
                                      err_msg=name)
    assert int(tn["map_valid"].sum()) == int(np.asarray(js.map_valid).sum())
