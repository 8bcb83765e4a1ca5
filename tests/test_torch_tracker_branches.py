"""The tracker's bootstrap fallbacks and its pipelined split, on both
trackers: the cases of ``tests/test_vo_jit.py`` that read tsukuba frames,
moved onto the synthetic two-plane scene (240x320, focal 280, slanted
background, the camera moving 0.12 units a frame along x) and run on the
JAX package's ``make_vo_step`` and the port's
``mvslam_tpu_torch.frontend.vo_jit``.

The port starts from the JAX tracker's state (``convert.state_from_numpy``)
and is fed the RANSAC uniforms the JAX step draws from its key, as
``tests/test_torch_vo.py`` feeds them; its outcome (success, mode,
``init_tried``) must be JAX's, and its pose within that file's ``T_ATOL`` /
``R_ATOL``, but at the one bootstrap where an inherited sensitivity is
located (``INHERITED_REFIT``).

- Window past a blank frame: ``[f0, blank, f1]``. The blank finds no pair;
  at f1 the bootstrap ring reaches back past it to f0 and bootstraps with
  the f0-f1 baseline.
- Fallback walk: the reference's construction, retuned to this scene by
  taking every second frame (f0, f2, f4: a 0.24-unit baseline). f0 is
  stored under a gate nothing passes and its ring rays are perturbed by
  0.13 px Gaussian noise (the reference's 0.13 px); f2 is rejected and
  joins the ring. At f4, with a loose gate (2.0) the oldest slot (the
  perturbed f0) is accepted on the first try with a refined error above
  0.10; with a 0.10 gate (the reference's) the walk passes it and accepts
  the clean f2 slot on the second try.
- Pipelined split: the port's ``make_vo_pipelined`` against its
  ``make_vo_step`` over the 8-frame scene.

| reference case | | where |
|---|---|---|
| `test_vo_jit.py::test_bootstrap_then_track` | b | `test_torch_vo.py::test_modes_match_frame_by_frame`, `test_success_matches_frame_by_frame` (bootstrap, then tracking, on this scene) |
| `test_vo_jit.py::test_trajectory_envelope` | c | the unit-x envelope is tsukuba's camera path; on this scene the poses are held to JAX's frame by frame (`test_torch_vo.py::test_poses_match_frame_by_frame`) |
| `test_vo_jit.py::test_state_bookkeeping` | b | `test_torch_vo.py::test_final_state_bookkeeping_matches` |
| `test_vo_jit.py::test_reset_on_garbage_frame` | b | `test_torch_vo.py` (frame 4 is blank: the reset to INITIALIZING, frame by frame against JAX) |
| `test_vo_jit.py::test_pipelined_split_matches_fused_step` | a | `test_pipelined_split_matches_fused_step` |
| `test_vo_jit.py::test_bootstrap_window_skips_garbage_frame` | a | `test_bootstrap_window_skips_blank_frame` |
| `test_vo_jit.py::test_bootstrap_falls_back_when_oldest_slot_fails_error_gate` | a | `test_bootstrap_falls_back_when_oldest_slot_fails_error_gate` |
"""

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

H, W, FOCAL = 240, 320, 280.0
N_FRAMES = 8
PERTURB_PX = 0.13
GATE = 0.10


@pytest.fixture(scope="module")
def scene():
    i = np.arange(N_FRAMES)
    ts = np.stack([i * 0.12, 0.02 * np.sin(i * 0.25), np.zeros(N_FRAMES)], 1)
    frames = render_planes_sequence(ts, h=H, w=W, focal=FOCAL, bg_slope=0.18)
    K_inv = np.linalg.inv(np.asarray(
        [[FOCAL, 0, (W - 1) / 2], [0, FOCAL, (H - 1) / 2], [0, 0, 1]]))
    return frames, ts, K_inv


class Trackers:
    """One JAX step and one port step, both at the default
    ``VoJitParams()``."""

    def __init__(self, K_inv):
        self.jp, self.tp = jv.VoJitParams(), tv.VoJitParams()
        self.jstep = jv.make_vo_step(self.jp)
        self.tstep = tv.make_vo_step(self.tp)
        self.jK = jnp.asarray(K_inv, jnp.float32)
        self.jf = jnp.asarray(FOCAL, jnp.float32)
        self.tK = torch.tensor(K_inv, dtype=torch.float32)
        self.tf = torch.tensor(FOCAL, dtype=torch.float32)

    def jax(self, js, image):
        return self.jstep(js, jnp.asarray(image), self.jK, self.jf)

    def port(self, ts, image, js):
        """The port's step from ``ts`` under the draws the JAX step takes
        from ``js``."""
        draws = _jax_draws(js, self.jp)
        return self.tstep(ts, torch.from_numpy(np.asarray(image)), self.tK,
                          self.tf,
                          None if draws is None else torch.tensor(draws))


def port_state(js):
    return state_from_numpy(
        {k: np.asarray(v) for k, v in js._asdict().items() if k != "key"},
        device="cpu")


@pytest.fixture(scope="module")
def trackers(scene):
    return Trackers(scene[2])


#: the f2-f4 bootstrap of the fallback walk (ROADMAP Queue 3,
#: "Inherited"): the scene is two planes, so the Sampson-weighted eigh
#: refits of the essential matrix on the consensus set are chaotic in any
#: precision (inlier counts 180 -> 75 -> 114 -> 194 in the port, 181 ->
#: 194 -> 29 -> 108 in JAX, 180 -> 74 -> 144 -> 92 in float64), and
#: whether the refit is kept (it must lose no inliers) flips between the
#: packages: the port keeps it, JAX does not. The Sampson polish and the
#: LM refine then end 9.5e-4 apart in translation and 2.9e-4 in rotation;
#: the outcome (success, mode, slots tried) is the same.
INHERITED_REFIT = (2e-3, 1e-3)


def assert_same_outcome(to, jo, what, atol=(T_ATOL, R_ATOL)):
    assert bool(to.success) == bool(jo.success), what
    assert int(to.mode) == int(jo.mode), what
    assert int(to.init_tried) == int(jo.init_tried), what
    np.testing.assert_allclose(to.pose_t.numpy(), np.asarray(jo.pose_t),
                               rtol=0, atol=atol[0], err_msg=what)
    np.testing.assert_allclose(to.pose_R.numpy(), np.asarray(jo.pose_R),
                               rtol=0, atol=atol[1], err_msg=what)


def test_bootstrap_window_skips_blank_frame(scene, trackers):
    frames, ts_gt, _ = scene
    blank = np.zeros((H, W), np.float32)
    js = jv.vo_init_state(trackers.jp)
    ts = port_state(js)
    outs = []
    for image in (frames[0], blank, frames[1]):
        ts, to = trackers.port(ts, image, js)
        js, jo = trackers.jax(js, image)
        outs.append((to, jo))
    for k, (to, jo) in enumerate(outs):
        assert_same_outcome(to, jo, f"frame {k}")
    (_, _), (to2, jo2), (to3, jo3) = outs
    assert not bool(jo2.success) and not bool(to2.success)
    for o in (to3, jo3):
        assert bool(o.success), "the window must reach back past the blank"
        assert int(o.mode) == tv.MODE_TRACKING
    # the f0-f1 baseline: unit-norm translation along the true direction
    baseline = ts_gt[1] - ts_gt[0]
    baseline /= np.linalg.norm(baseline)
    assert np.abs(to3.pose_t.numpy() - baseline).max() < 0.08
    # chip_smoke.py holds the card to this bar with its own predicate
    import chip_smoke as cs

    assert cs.window_ok({f"window_{k}": to for k, (to, _) in enumerate(outs)},
                        baseline)


def test_bootstrap_falls_back_when_oldest_slot_fails_error_gate(
        scene, trackers):
    frames, _, _ = scene

    def with_gate(st, g):
        return st._replace(gate_pair_err=jnp.asarray(g, jnp.float32))

    js = with_gate(jv.vo_init_state(trackers.jp, seed=4), 1e-9)
    js, _ = trackers.jax(js, frames[0])
    rng = np.random.default_rng(7)
    pert = rng.normal(scale=PERTURB_PX / FOCAL, size=(js.rb_rays.shape[1], 2))
    rb = np.array(js.rb_rays)
    rb[0, :, :2] += pert
    js = js._replace(rb_rays=jnp.asarray(rb, js.rb_rays.dtype))
    js, o2 = trackers.jax(js, frames[2])
    assert not bool(o2.success)

    runs = {}
    for gate in (2.0, GATE):
        jg = with_gate(js, gate)
        _, jo = trackers.jax(jg, frames[4])
        _, to = trackers.port(port_state(jg), frames[4], jg)
        assert_same_outcome(
            to, jo, f"gate {gate}",
            INHERITED_REFIT if gate == GATE else (T_ATOL, R_ATOL))
        runs[gate] = (to, jo)
    for i in range(2):                       # the port, then JAX
        hi, lo = runs[2.0][i], runs[GATE][i]
        # loose gate: the first walked slot, the perturbed oldest, is taken
        assert bool(hi.success)
        assert int(hi.init_tried) == 1
        assert float(hi.mean_error) > GATE, float(hi.mean_error)
        # tight gate: the walk passes it and the clean younger slot rescues
        # the frame
        assert bool(lo.success), "the younger slot must rescue the frame"
        assert int(lo.init_tried) == 2, int(lo.init_tried)
        assert int(lo.mode) == tv.MODE_TRACKING
        assert float(lo.mean_error) <= GATE, float(lo.mean_error)
        assert int(lo.num_inliers) > int(hi.num_inliers)
    # chip_smoke.py holds the card to these bars with its own predicate
    import chip_smoke as cs

    assert (cs.BRANCH_PERTURB_PX, cs.BRANCH_LOOSE_GATE, cs.BRANCH_GATE) == (
        PERTURB_PX, 2.0, GATE)
    for i in range(2):
        assert cs.walk_ok({"walk_f2": o2, f"walk_{cs.BRANCH_LOOSE_GATE}":
                           runs[2.0][i], f"walk_{cs.BRANCH_GATE}":
                           runs[GATE][i]})


def test_pipelined_split_matches_fused_step(scene):
    frames, _, K_inv = scene
    params = tv.VoJitParams()
    step = tv.make_vo_step(params)
    pre, combine = tv.make_vo_pipelined(params)
    K = torch.tensor(K_inv, dtype=torch.float32)
    focal = torch.tensor(FOCAL, dtype=torch.float32)
    fused = tv.vo_init_state(params, device="cpu")
    split = tv.vo_init_state(params, device="cpu")
    tracked = 0
    for k, frame in enumerate(frames):
        image = torch.from_numpy(frame)
        fused, o_fused = step(fused, image, K, focal)
        f, smooth = pre(image, K, focal)
        split, o_split = combine(split, f, smooth, K, focal)
        assert bool(o_split.success) == bool(o_fused.success), k
        np.testing.assert_allclose(o_split.pose_t.numpy(),
                                   o_fused.pose_t.numpy(), atol=1e-5)
        tracked += bool(o_fused.success)
    assert tracked >= N_FRAMES - 2, tracked


#: the two trackers' bootstrap in float64, fed the same draws (measured:
#: 2.3e-7 in translation at the walk, 1e-8 elsewhere)
F64_ATOL = 1e-6


def _in_float64(js):
    """The JAX tracker's state with every floating field in float64."""
    return js._replace(**{
        k: v.astype(jnp.float64) for k, v in js._asdict().items()
        if k != "key" and jnp.issubdtype(v.dtype, jnp.floating)})


@pytest.fixture(scope="module")
def bootstrap_states(scene, trackers):
    """JAX's float32 state before each bootstrap step of the two files'
    scenes, and the image of that step: frames 1 and 6 of
    ``test_torch_vo.py``'s run (frame 4 blank), the walk's f4 under both
    gates."""
    frames, _, _ = scene
    vo = frames.copy()
    vo[4] = 0.0
    out = {}
    js = jv.vo_init_state(trackers.jp)
    for k in range(7):
        if k in (1, 6):
            out[f"vo_frame_{k}"] = (js, vo[k])
        js, _ = trackers.jax(js, vo[k])

    def with_gate(st, g):
        return st._replace(gate_pair_err=jnp.asarray(g, jnp.float32))

    js = with_gate(jv.vo_init_state(trackers.jp, seed=4), 1e-9)
    js, _ = trackers.jax(js, frames[0])
    rng = np.random.default_rng(7)
    pert = rng.normal(scale=PERTURB_PX / FOCAL, size=(js.rb_rays.shape[1], 2))
    rb = np.array(js.rb_rays)
    rb[0, :, :2] += pert
    js, _ = trackers.jax(js._replace(rb_rays=jnp.asarray(rb, js.rb_rays.dtype)),
                         frames[2])
    for gate in (2.0, GATE):
        out[f"walk_{gate}"] = (with_gate(js, gate), frames[4])
    return out


@pytest.mark.parametrize("step", ["vo_frame_1", "vo_frame_6", "walk_2.0",
                                  "walk_0.1"])
def test_bootstrap_steps_agree_with_jax_in_float64(bootstrap_states,
                                                   trackers, step):
    """Each bootstrap step of the parity files, run in float64 by both
    trackers from JAX's state under JAX's draws: the same outcome and pose.
    (In float64 neither bootstraps at frames 1 and 6: the float32 successes
    there are the last bits' lottery, ROADMAP Queue 3.)"""
    js, image = bootstrap_states[step]
    j64 = _in_float64(js)
    _, jo = trackers.jstep(j64, jnp.asarray(image, jnp.float64),
                           jnp.asarray(trackers.jK, jnp.float64),
                           jnp.asarray(FOCAL, jnp.float64))
    ts = port_state(js)
    ts = ts._replace(**{k: v.double() for k, v in ts._asdict().items()
                        if torch.is_tensor(v) and v.is_floating_point()})
    _, pre, combine = tv._make_vo_step_fns(trackers.tp)
    f, smooth = pre(torch.from_numpy(np.asarray(image)), trackers.tK,
                    trackers.tf)
    f = f._replace(**{k: v.double() for k, v in f._asdict().items()
                      if v.is_floating_point()})
    draws = _jax_draws(js, trackers.jp)
    _, to = combine(ts, f, smooth.double(), trackers.tK.double(),
                    trackers.tf.double(),
                    None if draws is None else torch.tensor(draws))
    assert_same_outcome(to, jo, step, (F64_ATOL, F64_ATOL))
