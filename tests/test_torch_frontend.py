"""The PyTorch port's host-orchestrated front end against the JAX package's:
``sfm_solve`` / ``pnp_solve`` / ``pnp_refine``, ``FrameManager``,
``ImagePair`` and ``VisualOdometer``, on the CPU, float32 on both sides
(set explicitly: the test configuration turns on x64).

RANSAC draws: the JAX package seeds a key per solve and draws
``jax.random.uniform(key, (hypotheses, N))``; the port is handed those
uniforms, so both sides solve the same minimal sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import CUBE, L_SHAPE, get_rig_points, random_se3, se3_from_parts
from mvslam_tpu.frontend import visual_odometer as jvo
from mvslam_tpu.frontend.frame_manager import FrameManager as JFrameManager
from mvslam_tpu.frontend.image_pair import ImagePair as JImagePair
from mvslam_tpu.math.lie import so3_from_rpy
from mvslam_tpu.ops import pnp as jpnp
from mvslam_tpu.ops import sfm as jsfm
from mvslam_tpu.ops.camera import PinholeCamera as JCamera
from mvslam_tpu_torch import convert
from mvslam_tpu_torch.frontend import visual_odometer as tvo
from mvslam_tpu_torch.frontend.camera_manager import CameraManager
from mvslam_tpu_torch.frontend.frame_manager import FpsEstimator, FrameManager
from mvslam_tpu_torch.frontend.image_pair import ImagePair, PairState
from mvslam_tpu_torch.math.lie import SE3 as TSE3
from mvslam_tpu_torch.ops import pnp as tpnp
from mvslam_tpu_torch.ops import sfm as tsfm
from mvslam_tpu_torch.ops.camera import PinholeCamera
from mvslam_tpu_torch.utils.indexing import masked_take, set_rows
from mvslam_tpu_torch.utils.scene import render_planes_sequence

H, W, FOCAL = 240, 320, 280.0
N_FRAMES = 10
#: poses after iterative float32 solvers (power iterations, Gauss-Newton,
#: LM) whose reductions run in another order in each package
POSE_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The odometer on the CPU is thousands of tiny ops per frame: with the
    suite's workers side by side, torch's intra-op pool only makes them
    fight for the cores (measured: this file 4-40x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j(a):
    return jnp.asarray(np.asarray(a), jnp.float32)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _uniforms(seed, n, hypotheses=256):
    """What ``ransac.sample_minimal_sets`` draws from ``PRNGKey(seed)``."""
    return torch.tensor(np.asarray(
        jax.random.uniform(jax.random.PRNGKey(seed), (hypotheses, n))))


def _close(got, want, atol=POSE_ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=msg)


# ---------------------------------------------------------------------------
# (b) sfm_solve, pnp_solve, pnp_refine on the rigs of the JAX package's tests
# ---------------------------------------------------------------------------


def _project(pose, points):
    p_cam = pose.inverse().apply(points)
    return p_cam / p_cam[..., 2:3]


def _rig(rig):
    return get_rig_points(
        rig, rotation=np.asarray(so3_from_rpy(0.1, -0.2, 0.3,
                                              dtype=jnp.float64)),
        translation=(0.3, -0.2, 6.0), dtype=jnp.float32)


@pytest.mark.parametrize("rig", [CUBE, L_SHAPE])
@pytest.mark.parametrize("seed", [0, 3])
def test_sfm_solve_matches(rig, seed):
    """The two-view rig of ``tests/test_sfm.py`` (camera 2 at +x) with 8
    masked pad rows: equal inlier and point masks, pose and points within
    POSE_ATOL."""
    points = _rig(rig)
    pose2in1 = se3_from_parts(np.eye(3), [1.0, 0.0, 0.0], dtype=jnp.float32)
    pad = jnp.zeros((8, 3), jnp.float32)
    r1 = jnp.concatenate([points / points[:, 2:3], pad])
    r2 = jnp.concatenate([_project(pose2in1, points), pad])
    mask = jnp.arange(16) < 8
    want = jsfm.sfm_solve(r1, r2, mask, jax.random.PRNGKey(seed))
    got = tsfm.sfm_solve(_t(r1), _t(r2), torch.from_numpy(np.asarray(mask)),
                         uniforms=_uniforms(seed, 16))
    assert bool(got.success) == bool(want.success) is True
    assert int(got.num_inliers) == int(want.num_inliers) == 8
    assert int(got.num_points) == int(want.num_points)
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  np.asarray(want.inlier_mask))
    np.testing.assert_array_equal(got.point_mask.numpy(),
                                  np.asarray(want.point_mask))
    _close(got.pose2in1.R, want.pose2in1.R)
    _close(got.pose2in1.t, want.pose2in1.t)
    pm = np.asarray(want.point_mask)
    # points 6 units away: relative 1e-4
    _close(got.points.numpy()[pm], np.asarray(want.points)[pm], atol=6e-4)
    # E up to sign, unit Frobenius norm on both sides
    E, Ew = got.E.numpy(), np.asarray(want.E)
    assert min(np.abs(E - Ew).max(), np.abs(E + Ew).max()) < POSE_ATOL


def _pnp_scene(rng, n_in=40, n_out=14):
    pts = np.c_[rng.uniform(-2, 2, (n_in + n_out, 2)),
                rng.uniform(4, 9, n_in + n_out)]
    pose = se3_from_parts(
        np.asarray(so3_from_rpy(0.1, 0.05, -0.07, dtype=jnp.float64)),
        [0.5, -0.3, 0.2], dtype=jnp.float32)
    r = np.array(_project(pose, _j(pts)))
    r[n_in:, :2] += rng.uniform(0.2, 0.6, (n_out, 2))
    return _j(pts), _j(r), pose


@pytest.mark.parametrize("seed", [5, 6])
def test_pnp_solve_matches(seed):
    """The outlier scene of ``tests/test_ba.py``: equal inlier masks, pose
    within POSE_ATOL."""
    pts, r, pose = _pnp_scene(np.random.default_rng(seed))
    n = pts.shape[0]
    mask = jnp.ones(n, bool)
    want = jpnp.pnp_solve(pts, r, mask, jax.random.PRNGKey(seed),
                          jpnp.PnpParams(num_hypotheses=512, threshold=0.01))
    got = tpnp.pnp_solve(_t(pts), _t(r), torch.ones(n, dtype=torch.bool),
                         tpnp.PnpParams(num_hypotheses=512, threshold=0.01),
                         uniforms=_uniforms(seed, n, 512))
    assert bool(got.success) == bool(want.success) is True
    assert int(got.num_inliers) == int(want.num_inliers) == 40
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  np.asarray(want.inlier_mask))
    _close(got.pose.R, want.pose.R)
    _close(got.pose.t, want.pose.t)
    _close(got.pose.log(), pose.log(), atol=1e-3)


def test_pnp_solve_generator_is_seeded():
    """Without ``uniforms`` the draws come from the generator: the same
    seed gives the same pose, bit for bit."""
    pts, r, _ = _pnp_scene(np.random.default_rng(1))
    mask = torch.ones(pts.shape[0], dtype=torch.bool)
    a, b = (tpnp.pnp_solve(_t(pts), _t(r), mask,
                           generator=torch.Generator().manual_seed(7))
            for _ in range(2))
    assert torch.equal(a.pose.t, b.pose.t) and torch.equal(a.pose.R, b.pose.R)


def test_pnp_refine_matches(rng):
    """The noisy cube of ``tests/test_ba.py``: refined pose, covariance and
    error against the JAX package's."""
    noise = 2e-3
    points = _rig(CUBE)
    pose = se3_from_parts(
        np.asarray(so3_from_rpy(-0.04, 0.06, 0.1, dtype=jnp.float64)),
        [0.4, -0.2, 0.3], dtype=jnp.float32)
    r = _project(pose, points)
    r = r.at[:, :2].add(_j(rng.normal(0, noise, (8, 2))))
    pose0 = pose.compose(random_se3(rng, 0.02, dtype=jnp.float32))
    reg = 1e4 * np.eye(6)
    pinfo = np.broadcast_to(np.eye(3) / noise ** 2, (8, 3, 3))
    w = np.full(8, 1.0 / noise)
    want_pose, want_cov, want_err = jpnp.pnp_refine(
        pose0, _j(reg), points, _j(pinfo), r, obs_weight=_j(w),
        mask=jnp.ones(8, bool))
    got_pose, got_cov, got_err = tpnp.pnp_refine(
        TSE3(_t(pose0.R), _t(pose0.t)), _t(reg), _t(points), _t(pinfo),
        _t(r), obs_weight=_t(w), mask=torch.ones(8, dtype=torch.bool))
    _close(got_pose.R, want_pose.R)
    _close(got_pose.t, want_pose.t)
    # float32 LM on a cost of ~10: relative 1e-3
    np.testing.assert_allclose(float(got_err), float(want_err), rtol=1e-3)
    np.testing.assert_allclose(got_cov.numpy(), np.asarray(want_cov),
                               rtol=1e-2, atol=1e-9)


# ---------------------------------------------------------------------------
# (f) writes through repeating indices and slot allocation, against numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trailing", [(), (3,), (2, 2)])
def test_set_rows_keeps_numpys_last_write(rng, trailing):
    """Indices that repeat (and some out of range, which are dropped): the
    highest source position wins, as ``a[idx] = v`` in numpy."""
    n, k = 12, 40
    idx = rng.integers(0, n, k)
    assert len(set(idx.tolist())) < k            # they do repeat
    vals = rng.normal(size=(k,) + trailing)
    dst = rng.normal(size=(n,) + trailing)
    want = dst.copy()
    want[idx] = vals
    got = set_rows(torch.tensor(dst), torch.tensor(idx), torch.tensor(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    # dropped: negative and >= n
    idx2 = np.concatenate([idx, [-1, n, n + 5]])
    vals2 = np.concatenate([vals, rng.normal(size=(3,) + trailing)])
    got = set_rows(torch.tensor(dst), torch.tensor(idx2), torch.tensor(vals2))
    np.testing.assert_array_equal(got.numpy(), want)
    # a scalar value
    got = set_rows(torch.tensor(dst), torch.tensor(idx), 7.0)
    want[idx] = 7.0
    np.testing.assert_array_equal(got.numpy(), want)


def test_masked_take_is_flatnonzero(rng):
    mask = rng.uniform(size=50) < 0.4
    idx, ok = masked_take(torch.tensor(mask), 30)
    nz = np.flatnonzero(mask)
    assert int(ok.sum()) == len(nz) < 30
    np.testing.assert_array_equal(idx.numpy()[: len(nz)], nz)
    idx, ok = masked_take(torch.tensor(mask), 5)
    np.testing.assert_array_equal(idx.numpy(), nz[:5])
    assert bool(ok.all())


@pytest.mark.parametrize("n", [3, 10, 25, 40])
def test_map_allocate_matches_jax_package(rng, n):
    """``_Map.allocate`` against the JAX package's on a map whose valid
    slots were all seen at different steps (no ties: numpy's argsort is
    not stable, the port's rule for ties is the lower index)."""
    cap = 40
    jm, tm = jvo._Map(cap), tvo._Map(cap, "cpu")
    valid = rng.uniform(size=cap) < 0.8
    seen = np.where(valid, rng.permutation(cap) + 5, -1)
    jm.valid[:], jm.last_seen[:] = valid, seen
    tm.valid.copy_(torch.tensor(valid))
    tm.last_seen.copy_(torch.tensor(seen))
    want = jm.allocate(n, 99)[:n]
    got = tm.allocate(n, 99)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tm.count() == jm.count()


def test_map_allocate_tie_rule():
    tm = tvo._Map(6, "cpu")
    tm.valid.copy_(torch.tensor([True, True, False, True, True, False]))
    tm.last_seen.copy_(torch.tensor([4, 2, -1, 2, 4, -1]))
    # free slots ascending, then stale first, the lower index among equals
    assert tm.allocate(6, 9).tolist() == [2, 5, 1, 3, 0, 4]


def test_map_put_with_repeats(rng):
    tm = tvo._Map(8, "cpu")
    idx = torch.tensor([1, 5, 1, 7, 5, 5])
    vals = torch.tensor(rng.normal(size=(6, 3)), dtype=torch.float32)
    tm.put("positions", idx, vals)
    want = np.zeros((8, 3), np.float32)
    want[idx.numpy()] = vals.numpy()
    np.testing.assert_array_equal(tm.positions.numpy(), want)
    tm.put("valid", idx, True)
    assert tm.count() == 3


# ---------------------------------------------------------------------------
# (c), (d), (e) frames, pairs and the odometer on the rendered scene
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def images():
    i = np.arange(N_FRAMES)
    ts = np.stack([i * 0.12, 0.02 * np.sin(i * 0.25), np.zeros(N_FRAMES)], 1)
    return render_planes_sequence(ts, h=H, w=W, focal=FOCAL, bg_slope=0.18)


@pytest.fixture(scope="module")
def frames(images):
    """Every image through both frame managers: (JAX frames, port frames,
    the managers)."""
    args = (FOCAL, FOCAL, 0.0, (W - 1) / 2, (H - 1) / 2)
    jfm = JFrameManager(camera=JCamera.from_params(*args, dtype=jnp.float32))
    tfm = FrameManager(camera=PinholeCamera.from_params(*args), device="cpu")
    jf = [jfm.add_frame(0.1 * (k + 1), jnp.asarray(img, jnp.float32))
          for k, img in enumerate(images)]
    tf = [tfm.add_frame(0.1 * (k + 1), img) for k, img in enumerate(images)]
    return jf, tf, jfm, tfm


@pytest.fixture(scope="module")
def shared(frames):
    """The JAX package's frames carried into the port: the pair and the
    odometer are then compared on the same inputs, feature for feature.
    (Each package's own detector keeps the same keypoints, but Harris
    near-ties may swap two of them inside a level, and the RANSAC draws go
    by feature index.)"""
    jf = frames[0]
    return jf, [convert.frame_from_numpy(convert.frame_to_numpy(f), "cpu")
                for f in jf]


def _keyed(feats_np):
    return {(int(o), float(x), float(y)): i for i, (o, (x, y), m) in
            enumerate(zip(feats_np["octave"], feats_np["xy"],
                          feats_np["mask"])) if m}


def test_frame_manager_add_frame_matches(frames):
    """Equal feature masks; the kept keypoints are the same set (Harris
    near-ties may swap the order of two inside a level), each with the
    same descriptor words but for a rounding tie, and rays and sigma within 1e-6 (pixel
    coordinates through K^-1, float32 on both sides)."""
    jf, tf, jfm, tfm = frames
    swapped, flipped = 0, []
    for a, b in zip(jf, tf):
        fa = convert.feature_set_to_numpy(a.features)
        fb = convert.feature_set_to_numpy(b.features)
        np.testing.assert_array_equal(fb["mask"], fa["mask"])
        ka, kb = _keyed(fa), _keyed(fb)
        assert ka.keys() == kb.keys() and len(ka) > 300
        ia = np.array([ka[k] for k in ka])
        ib = np.array([kb[k] for k in ka])
        swapped += int((ia != ib).sum())
        flipped.append(int(np.unpackbits(
            (fb["desc"][ib] ^ fa["desc"][ia]).view(np.uint8)).sum()))
        _close(b.rays.numpy()[ib], np.asarray(a.rays)[ia], atol=1e-6)
        _close(b.sigma.numpy()[ib], np.asarray(a.sigma)[ia], atol=1e-6)
        _close(b.image_smooth, a.image_smooth, atol=1e-6)
        assert b.focal == a.focal == FOCAL
        assert b.capture_time == a.capture_time
        assert b.rays.dtype == torch.float32 and b.rays.device.type == "cpu"
        assert b.camera is tfm.camera and b.image is not None
    assert swapped <= 8, swapped          # of ~5000 keypoints in 10 frames
    # a BRIEF bit compares two smoothed pixels; where they tie to float32
    # rounding the packages' summation orders may disagree: at most one
    # bit of a frame's ~100 000, and none on most frames (measured: one
    # bit on each of 3 frames of the 10)
    assert max(flipped) <= 1 and sum(flipped) <= 5, flipped
    ids = [f.id for f in tf]
    assert ids == sorted(set(ids))                 # unique and increasing
    assert tfm.size() == jfm.size() == N_FRAMES
    assert tfm.get_frame(ids[3]) is tf[3]
    tfm.erase_frame(ids[3])
    assert tfm.size() == N_FRAMES - 1
    tfm._frames[ids[3]] = tf[3]


def test_frames_cross_between_packages(shared):
    """``convert`` carries a frame over bit for bit."""
    jf, sf = shared
    for a, b in zip(jf, sf):
        assert (b.id, b.capture_time, b.focal) == (a.id, a.capture_time,
                                                   a.focal)
        for name in ("rays", "sigma", "image", "image_smooth"):
            np.testing.assert_array_equal(getattr(b, name).numpy(),
                                          np.asarray(getattr(a, name)))
        fa = convert.feature_set_to_numpy(a.features)
        fb = convert.feature_set_to_numpy(b.features)
        for k in fa:
            np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)
            assert fb[k].dtype == fa[k].dtype, k
        assert b.features.desc.dtype == torch.int32
        np.testing.assert_array_equal(b.camera.K.numpy(),
                                      np.asarray(a.camera.K))


def test_fps_estimator_matches():
    """The 2-state filter over a jittered 10 Hz clock, float64 on both
    sides (x64 is on): 1e-10 relative. Its state stays on the CPU."""
    from mvslam_tpu.frontend.frame_manager import FpsEstimator as JFps

    rng = np.random.default_rng(3)
    times = np.cumsum(0.1 + 0.01 * rng.normal(size=40))
    je, te = JFps(), FpsEstimator()
    assert te.fps == je.fps == 0.0
    for t in times:
        want, got = je.update(float(t)), te.update(float(t))
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert te.fps == pytest.approx(10.0, rel=0.05)
    assert te._state.x.device.type == "cpu"


def test_camera_manager(tmp_path):
    cm = CameraManager(device="cpu")
    np.testing.assert_array_equal(cm.get_camera().K.numpy(), np.eye(3))
    cam = PinholeCamera.from_params(300.0, 310.0, 0.5, 160.0, 120.0)
    cm.set_camera(cam)
    cm.save_to_file(str(tmp_path / "camera.config"))
    other = CameraManager(device="cpu")
    got = other.load_from_file(str(tmp_path / "camera.config"))
    np.testing.assert_array_equal(got.K.numpy(), cam.K.numpy())
    assert other.get_camera() is got


@pytest.mark.parametrize("base,pair,t_atol,err_rtol", [
    (0, 1, POSE_ATOL, 1e-3), (0, 2, POSE_ATOL, 1e-3), (1, 4, POSE_ATOL, 1e-3),
    (0, 3, 3e-2, 5e-2)])
def test_image_pair_matches(shared, base, pair, t_atol, err_rtol):
    """On the same frames: equal state, inlier mask and inlier descriptor
    SSD; after refine the mean error within 1e-3 relative and the pose
    within POSE_ATOL. Pair (0, 3) shows the solver's one sensitivity: its
    LM ends on a flat floor where float32 noise decides the stopping
    iteration (identical inputs give identical iterates in both packages;
    a 2e-3 difference in the polished start moves the end by 1.2e-2 along
    the valley, at an error 2 % apart), so its bars are wider."""
    jf, tf = shared
    K = tf[0].features.capacity
    want = JImagePair(jf[base], jf[pair], seed=4)
    got = ImagePair(tf[base], tf[pair], seed=4, uniforms=_uniforms(4, K))
    assert got.state.name == want.state.name == "RECONSTRUCTED"
    assert got.match_inlier_count == want.match_inlier_count >= 20
    assert got.match_inlier_ssd == want.match_inlier_ssd
    np.testing.assert_array_equal(got.result.inlier_mask.numpy(),
                                  np.asarray(want.result.inlier_mask))
    # before the BA the pose is a 6-iteration Sampson polish from an
    # essential-matrix decomposition, whose SVD turns freely inside E's
    # (nearly) double singular plane: 5e-3 on a unit baseline
    _close(got.T_pair_to_base.t, want.T_pair_to_base.t, atol=5e-3)
    assert got.refine() == want.refine()
    assert got.state.name == want.state.name == "REFINED"
    np.testing.assert_allclose(got.mean_error, want.mean_error,
                               rtol=err_rtol)
    np.testing.assert_allclose(got.error, want.error, rtol=err_rtol)
    _close(got.T_pair_to_base.R, want.T_pair_to_base.R, atol=max(
        POSE_ATOL, t_atol / 50))
    _close(got.T_pair_to_base.t, want.T_pair_to_base.t, atol=t_atol)
    pts, pmask = got.points
    wpts, wmask = want.points
    # the points in front of both cameras, under each side's own pose
    assert int((pmask.numpy() != np.asarray(wmask)).sum()) <= (
        0 if t_atol == POSE_ATOL else 2)


def test_image_pair_update_swaps_in_a_better_frame(frames):
    """``update`` takes over the candidate's every attribute when it has
    at least as many inliers and a lower error, and only then."""
    _, tf, _, _ = frames
    K = tf[0].features.capacity
    u = _uniforms(1, K)
    pair = ImagePair(tf[0], tf[1], seed=1, uniforms=u)
    pair.refine()
    before = dict(vars(pair))
    pair.match_inlier_count = 10 ** 6                  # nothing beats this
    assert pair.update(tf[2], uniforms=u) is False
    pair.match_inlier_count = before["match_inlier_count"]
    assert vars(pair) == before
    pair.error = float("inf")                          # anything beats this
    pair.match_inlier_count = 0
    assert pair.update(tf[2], uniforms=u) is True
    assert pair.pair is tf[2] and pair.state == PairState.REFINED
    assert np.isfinite(pair.error) and pair.match_inlier_count > 0


def test_image_pair_without_images_uses_raw_rays(shared):
    """No image on a frame: no KLT, the matched rays themselves."""
    import dataclasses

    jf, tf = shared
    K = tf[0].features.capacity
    bare_t = [dataclasses.replace(f, image=None) for f in tf[:2]]
    bare_j = [dataclasses.replace(f, image=None) for f in jf[:2]]
    want = JImagePair(bare_j[0], bare_j[1], seed=2)
    got = ImagePair(bare_t[0], bare_t[1], seed=2, uniforms=_uniforms(2, K))
    assert got.state.name == want.state.name
    assert got.match_inlier_count == want.match_inlier_count
    assert torch.equal(got._r2, bare_t[1].rays[got.match.idx])


@pytest.fixture(scope="module")
def odometers(shared):
    """The ten frames (the same on both sides) through both odometers, the
    port fed the JAX package's draws: per-frame results, and both
    odometers' state after every frame."""
    jf, tf = shared
    K = tf[0].features.capacity
    jv, tv = jvo.VisualOdometer(), tvo.VisualOdometer(device="cpu")
    rows = []
    for k in range(N_FRAMES):
        want = jv.add_frame(jf[k])
        got = tv.add_frame(tf[k], uniforms=_uniforms(jv._step, K))
        rows.append((want, got, convert.odometer_to_numpy(jv, window=False),
                     convert.odometer_to_numpy(tv, window=False)))
    return rows, jv, tv


def test_odometer_results_match_frame_by_frame(odometers):
    rows, jv, tv = odometers
    assert [g.success for _, g, _, _ in rows] == [w.success
                                                  for w, _, _, _ in rows]
    assert [g.reason for _, g, _, _ in rows] == [w.reason
                                                 for w, _, _, _ in rows]
    # the parity holds something: the JAX run bootstraps and tracks
    assert sum(w.success for w, _, _, _ in rows) >= 6
    assert "bootstrap" in [w.reason for w, _, _, _ in rows]
    assert "tracked" in [w.reason for w, _, _, _ in rows]
    assert tv.frame_total == jv.frame_total == N_FRAMES
    assert tv.frame_tracked == jv.frame_tracked
    assert tv.state.name == jv.state.name


def test_odometer_inliers_and_poses_match(odometers):
    """Equal inlier counts; ``t`` within 3e-4 of the distance travelled
    (unit: the bootstrap baseline; the run ends 7 baselines out; measured
    1.6e-4: each frame's LM ends on its float32 floor, see
    ``test_image_pair_matches``), ``R`` within POSE_ATOL; the mean error of
    the two-frame BA within 1e-2 relative."""
    rows, _, _ = odometers
    for k, (want, got, _, _) in enumerate(rows):
        assert got.num_inliers == want.num_inliers, k
        if not want.success:
            assert got.pose is None and want.pose is None
            continue
        reach = max(1.0, float(np.linalg.norm(np.asarray(want.pose.t))))
        _close(got.pose.t, want.pose.t, atol=3e-4 * reach,
               msg=f"frame {k}")
        _close(got.pose.R, want.pose.R, msg=f"frame {k}")
        np.testing.assert_allclose(got.mean_error, want.mean_error,
                                   rtol=1e-2, err_msg=f"frame {k}")


def test_odometer_state_matches_after_every_frame(odometers):
    """The map's valid slots, what is seen when, the association and the
    descriptor words equal after every frame; positions and carried
    observations close."""
    rows, _, _ = odometers
    for k, (_, _, jd, td) in enumerate(rows):
        assert td["state"] == jd["state"] and td["step"] == jd["step"]
        valid = jd["map_valid"]
        np.testing.assert_array_equal(td["map_valid"], valid, err_msg=str(k))
        assert td["map_valid"].sum() == valid.sum()
        np.testing.assert_array_equal(td["map_last_seen"],
                                      jd["map_last_seen"])
        np.testing.assert_array_equal(td["map_desc"][valid],
                                      jd["map_desc"][valid])
        # map points lie 30-60 baselines away: their bearing is held to
        # 2e-3, their depth (the weak direction of a two-view solve with
        # no prior on the points) to 5 %
        tp, jp = td["map_positions"][valid], jd["map_positions"][valid]
        tn, jn = (np.linalg.norm(a, axis=1, keepdims=True) for a in (tp, jp))
        _close(tp / tn, jp / jn, atol=2e-3, msg=f"bearings, frame {k}")
        np.testing.assert_allclose(tn, jn, rtol=5e-2,
                                   err_msg=f"depths, frame {k}")
        if jd["state"] != "TRACKING":
            continue
        np.testing.assert_array_equal(td["last_assoc"], jd["last_assoc"])
        for name in ("last_obs_rays", "last_obs_sigma", "last_templates"):
            assert td[name].dtype == jd[name].dtype, name
            _close(td[name], jd[name], atol=1e-5, msg=f"{name} frame {k}")


def test_slice_end_to_end_matches(frames, odometers):
    """The slice as a whole, each package behind its own ``FrameManager``:
    images in, poses out. A keypoint pair swapped by a Harris near-tie
    changes which minimal sets the shared draws pick, so the bars are
    wider than on shared frames: equal success and reason per frame,
    inlier counts within 3, ``t`` within 1e-3 (unit: the baseline)."""
    _, tf, _, _ = frames
    rows, _, _ = odometers
    K = tf[0].features.capacity
    tv = tvo.VisualOdometer(device="cpu")
    for k in range(N_FRAMES):
        want = rows[k][0]
        got = tv.add_frame(tf[k], uniforms=_uniforms(k + 1, K))
        assert (got.success, got.reason) == (want.success, want.reason), k
        assert abs(got.num_inliers - want.num_inliers) <= 3, k
        if want.success:
            _close(got.pose.t, want.pose.t, atol=1e-3, msg=f"frame {k}")
    assert tv.num_tracked_points == pytest.approx(
        int(rows[-1][2]["map_valid"].sum()), abs=5)


def test_odometer_getters(odometers):
    _, jv, tv = odometers
    pts = tv.get_tracked_points()
    assert pts.shape == (tv.num_tracked_points, 3)
    assert tv.num_tracked_points == jv.num_tracked_points
    assert bool(torch.isfinite(pts).all())
    assert tv.get_body_pose() is tv.get_camera_pose()
    shift = TSE3(torch.eye(3), torch.tensor([0.0, 0.0, 1.0]))
    tv._T_cam_body = shift
    _close(tv.get_body_pose().t, tv.get_camera_pose().apply(shift.t),
           atol=1e-6)
    tv._T_cam_body = None
    assert len(tv.trajectory) == tv.frame_tracked


def test_odometer_takes_the_jax_state_midway(shared, odometers):
    """``convert`` carries the JAX odometer's whole state into the port:
    from JAX's state after frame 5 the port tracks frame 6 as JAX does."""
    jf, tf = shared
    rows, _, _ = odometers
    K = tf[0].features.capacity
    jv = jvo.VisualOdometer()
    for k in range(6):
        jv.add_frame(jf[k])
    assert jv.state.name == "TRACKING"
    tv = convert.odometer_from_numpy(convert.odometer_to_numpy(jv),
                                     tvo.VisualOdometer(device="cpu"))
    got = tv.add_frame(tf[6], uniforms=_uniforms(tv._step + 1, K))
    want = rows[6][0]
    assert (got.success, got.reason, got.num_inliers) == (
        want.success, want.reason, want.num_inliers)
    _close(got.pose.t, want.pose.t, atol=4 * POSE_ATOL)   # 4 baselines out


def test_odometer_reset_and_window(frames):
    """A blank frame while tracking resets to INITIALIZING with that frame
    as the window; the window never outgrows the queue."""
    _, tf, _, tfm = frames
    K = tf[0].features.capacity
    tv = tvo.VisualOdometer(tvo.VoParams(frame_queue_size=3), device="cpu")
    blank = tfm.add_frame(9.9, np.zeros((H, W), np.float32))
    tfm.erase_frame(blank.id)
    for k in range(4):
        res = tv.add_frame(blank, uniforms=_uniforms(k + 1, K))
        assert not res.success
        assert res.reason == ("need frames" if k == 0 else "no valid pair")
    assert len(tv._frames) == 3 and tv.pairs_tried == 2
    tv.reset()
    tv.add_frame(tf[0])
    assert tv.add_frame(tf[1], uniforms=_uniforms(6, K)).reason == "bootstrap"
    assert tv.state == tvo.VoState.TRACKING and tv._frames == []
    res = tv.add_frame(blank, uniforms=_uniforms(7, K))
    assert (res.success, res.reason) == (False, "pnp")
    assert tv.state == tvo.VoState.INITIALIZING
    assert tv._frames == [blank] and tv.num_tracked_points == 0
    assert tv.get_camera_pose() is None and tv.get_body_pose() is None
