"""Two-view geometry, RANSAC, P3P/PnP and bundle adjustment: the PyTorch
port against JAX on seeded synthetic scenes, float32 on both sides.

RANSAC draws: the port is fed the uniforms JAX draws from its key
(``jax.random.uniform(key, (hypotheses, N))``, as ``ransac.py`` does), so
both sides solve the same minimal sets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.math.lie import SE3 as JSE3
from mvslam_tpu.ops import ba as jba
from mvslam_tpu.ops import camera as jcam
from mvslam_tpu.ops import epipolar as jep
from mvslam_tpu.ops import p3p as jp3p
from mvslam_tpu.ops import pnp as jpnp
from mvslam_tpu.ops import ransac as jrs
from mvslam_tpu.ops import sfm as jsfm
from mvslam_tpu_torch.math.lie import SE3 as TSE3
from mvslam_tpu_torch.ops import ba as tba
from mvslam_tpu_torch.ops import camera as tcam
from mvslam_tpu_torch.ops import epipolar as tep
from mvslam_tpu_torch.ops import p3p as tp3p
from mvslam_tpu_torch.ops import pnp as tpnp
from mvslam_tpu_torch.ops import ransac as trs
from mvslam_tpu_torch.ops import sfm as tsfm

FOCAL = 300.0
#: poses/points after iterative float32 solvers (power iterations, LM,
#: Gauss-Newton) that sum in another order: relative drift ~1e-5
POSE_ATOL = 1e-4
#: pose from an essential matrix: E has two (nearly) equal singular
#: values, so the closed-form SVD's U, V turn freely inside that plane and
#: float32 rounding moves R = U W V^T by up to ~2e-4 (in both packages)
DECOMPOSE_ATOL = 1e-3


def _j(a):
    return jnp.asarray(np.asarray(a), jnp.float32)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


recover_j = jax.jit(jsfm.recover_pose_and_points)
polish_j = jax.jit(jep.refine_relative_pose_sampson)
triangulate_j = jax.jit(jsfm.sfm_triangulate)
refine_j = jax.jit(jsfm.sfm_refine, static_argnames=("ba_params", "gauge"))


def _close(got, want, atol=POSE_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.fixture(scope="module")
def two_view():
    """Points at depth 4-8 seen from the origin and from camera 2
    (translated ~unit along x, slightly rotated); 0.05 px noise (KLT-grade,
    so no inlier sits on the 0.22 px Sampson threshold), 10% gross
    outliers, 10% invalid rows."""
    rng = np.random.default_rng(11)
    n = 300
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 8, n)], 1)
    w = np.array([0.01, -0.02, 0.015])
    R2 = np.asarray(JSE3.exp(jnp.asarray(np.r_[0, 0, 0, w])).R)  # cam2->w
    t2 = np.array([1.0, 0.05, 0.03])
    Xc2 = (X - t2) @ R2                          # R2^T (X - t2)
    r1 = np.c_[X[:, :2] / X[:, 2:], np.ones(n)]
    r2 = np.c_[Xc2[:, :2] / Xc2[:, 2:], np.ones(n)]
    r1[:, :2] += rng.normal(0, 0.05 / FOCAL, (n, 2))
    r2[:, :2] += rng.normal(0, 0.05 / FOCAL, (n, 2))
    out = rng.uniform(size=n) < 0.1
    r2[out, :2] += rng.uniform(-0.05, 0.05, (out.sum(), 2))
    mask = rng.uniform(size=n) > 0.1
    return (r1.astype(np.float32), r2.astype(np.float32), mask,
            X.astype(np.float32), R2, t2)


@pytest.fixture(scope="module")
def ransac_pair(two_view):
    r1, r2, mask, *_ = two_view
    key = jax.random.PRNGKey(7)
    thr = 5e-2 / FOCAL ** 2
    ransac = jax.jit(jrs.essential_ransac,
                     static_argnames=("num_hypotheses", "threshold_sq"))
    want = ransac(_j(r1), _j(r2), jnp.asarray(mask), key,
                  num_hypotheses=256, threshold_sq=thr)
    u = np.asarray(jax.random.uniform(key, (256, r1.shape[0])))
    got = trs.essential_ransac(_t(r1), _t(r2), torch.from_numpy(mask), 256,
                               thr, uniforms=torch.from_numpy(u.copy()))
    return want, got


def test_sample_minimal_sets_same_indices():
    mask = np.random.default_rng(0).uniform(size=90) > 0.3
    key = jax.random.PRNGKey(3)
    want = np.asarray(jrs.sample_minimal_sets(key, jnp.asarray(mask), 64, 8))
    u = np.asarray(jax.random.uniform(key, (64, 90)))
    got = trs.sample_minimal_sets(torch.from_numpy(mask), 64, 8,
                                  uniforms=torch.from_numpy(u.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


def test_essential_ransac_same_consensus(ransac_pair):
    want, got = ransac_pair
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  np.asarray(want.inlier_mask))
    assert int(got.num_inliers) == int(want.num_inliers) > 200
    E_t, E_j = got.model.numpy(), np.asarray(want.model)
    sign = np.sign(np.sum(E_t * E_j))
    _close(sign * E_t, E_j, atol=1e-4)


def test_recover_pose_and_points(two_view, ransac_pair):
    r1, r2, *_ = two_view
    want, got = ransac_pair
    E = np.asarray(want.model)
    inl = np.asarray(want.inlier_mask)
    pj, Xj, mj = recover_j(_j(E), _j(r1), _j(r2),
                                              jnp.asarray(inl))
    pt, Xt, mt = tsfm.recover_pose_and_points(_t(E), _t(r1), _t(r2),
                                              torch.from_numpy(inl))
    _close(pt.R.numpy(), pj.R, atol=DECOMPOSE_ATOL)
    _close(pt.t.numpy(), pj.t, atol=DECOMPOSE_ATOL)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(Xt.numpy()[mt.numpy()],
                               np.asarray(Xj)[np.asarray(mj)],
                               rtol=DECOMPOSE_ATOL, atol=DECOMPOSE_ATOL)


def test_decompose_essential_matrix(ransac_pair):
    E = np.asarray(ransac_pair[0].model)
    Rj, tj = jep.decompose_essential_matrix(_j(E))
    Rt, tt = tep.decompose_essential_matrix(_t(E))
    _close(Rt.numpy(), Rj, atol=DECOMPOSE_ATOL)
    _close(tt.numpy(), tj, atol=DECOMPOSE_ATOL)


def test_refine_relative_pose_sampson(two_view, ransac_pair):
    r1, r2, *_ = two_view
    want, _ = ransac_pair
    inl = np.asarray(want.inlier_mask)
    p0, _, _ = recover_j(want.model, _j(r1), _j(r2),
                                            want.inlier_mask)
    pj = polish_j(p0, _j(r1), _j(r2), _j(inl))
    pt = tep.refine_relative_pose_sampson(TSE3(_t(p0.R), _t(p0.t)), _t(r1),
                                          _t(r2), _t(inl))
    _close(pt.R.numpy(), pj.R)
    _close(pt.t.numpy(), pj.t)


@pytest.mark.parametrize("gauge", ["scale_only", "regulator"])
def test_sfm_triangulate_and_refine(two_view, ransac_pair, gauge):
    """Triangulation under the polished pose, then two-view BA: the
    tracker's ``scale_only`` call (point information, no covariance) and
    the reference-parity ``regulator`` call (marginal covariances)."""
    r1, r2, *_ = two_view
    want, _ = ransac_pair
    inl = want.inlier_mask
    p0, _, _ = recover_j(want.model, _j(r1), _j(r2), inl)
    pj = polish_j(p0, _j(r1), _j(r2),
                                          inl.astype(jnp.float32))
    Xj, mj = triangulate_j(_j(r1), _j(r2), inl, pj)
    tpose = TSE3(_t(pj.R), _t(pj.t))
    Xt, mt = tsfm.sfm_triangulate(_t(r1), _t(r2), torch.from_numpy(
        np.asarray(inl)), tpose)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    _close(Xt.numpy()[mt.numpy()], np.asarray(Xj)[np.asarray(mj)], atol=1e-3)

    sig = np.full((2, r1.shape[0]), 0.3 / FOCAL, np.float32)
    if gauge == "scale_only":
        bj = jba.BAParams(max_iterations=10, compute_covariance=False,
                          compute_point_info=True)
        bt = tba.BAParams(max_iterations=10, compute_covariance=False,
                          compute_point_info=True)
    else:
        bj, bt = jba.BAParams(max_iterations=10), tba.BAParams(
            max_iterations=10)
    # both sides refine from the same (JAX) triangulation
    want_r = refine_j(_j(r1), _j(r2), mj, pj, Xj, obs_stddev=_j(sig),
                             ba_params=bj, gauge=gauge)
    got_r = tsfm.sfm_refine(_t(r1), _t(r2), torch.from_numpy(np.asarray(mj)),
                            tpose, _t(Xj), obs_stddev=_t(sig), ba_params=bt,
                            gauge=gauge)
    _close(got_r.pose2in1.R.numpy(), want_r.pose2in1.R)
    _close(got_r.pose2in1.t.numpy(), want_r.pose2in1.t)
    m = np.asarray(mj)
    _close(got_r.points.numpy()[m], np.asarray(want_r.points)[m], atol=1e-3)
    np.testing.assert_allclose(float(got_r.error), float(want_r.error),
                               rtol=1e-3)
    if gauge == "scale_only":
        info_j = np.asarray(want_r.point_information)[m]
        info_t = got_r.point_information.numpy()[m]
        np.testing.assert_allclose(info_t, info_j, rtol=1e-3,
                                   atol=1e-3 * np.abs(info_j).max())
    else:
        cov_j = np.asarray(want_r.pose_covariance)
        np.testing.assert_allclose(got_r.pose_covariance.numpy(), cov_j,
                                   rtol=0, atol=1e-2 * np.abs(cov_j).max())


@pytest.mark.parametrize("huber", [None, 3.0])
def test_ba_solve_two_frame_tracker_problem(huber):
    """The tracker's BA shape: frame 0 pinned by a 1e10 prior, frame 1
    free, points with isotropic priors; 0.3 px noise and a few gross
    outliers (Huber IRLS on and off); marginal covariances on."""
    rng = np.random.default_rng(12)
    P = 200
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-2, 2, P),
                  rng.uniform(4, 7, P)], 1)
    xi = np.stack([np.zeros(6), [0.3, 0.02, 0.01, 0.01, -0.02, 0.005]])
    poses = JSE3.exp(jnp.asarray(xi))
    Rs, ts = np.asarray(poses.R), np.asarray(poses.t)
    Xc = np.einsum("fji,fpj->fpi", Rs, X[None] - ts[:, None])
    obs = Xc[..., :2] / Xc[..., 2:] + rng.normal(0, 0.3 / FOCAL, (2, P, 2))
    obs[1, :4] += 0.03                                  # gross outliers
    mask = rng.uniform(size=(2, P)) > 0.1
    p0 = JSE3.exp(_j(xi + np.r_[[np.zeros(6)],
                                [rng.normal(0, 0.01, 6)]]))
    X0 = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    info = np.zeros((2, 6, 6), np.float32)
    info[0] = 1e10 * np.eye(6)
    pinfo = np.broadcast_to(np.eye(3) / 0.05 ** 2, (P, 3, 3)).astype(
        np.float32)
    weight = np.full((2, P), FOCAL / 0.3, np.float32)
    jprob = jba.BAProblem.create(
        poses0=p0, points0=_j(X0), obs=_j(obs), obs_mask=jnp.asarray(mask),
        obs_weight=_j(weight), pose_prior=p0, pose_prior_info=_j(info),
        point_prior=_j(X0), point_prior_info=_j(pinfo))
    tp0 = TSE3(_t(p0.R), _t(p0.t))
    tprob = tba.BAProblem.create(
        poses0=tp0, points0=_t(X0), obs=_t(obs),
        obs_mask=torch.from_numpy(mask), obs_weight=_t(weight),
        pose_prior=tp0, pose_prior_info=_t(info), point_prior=_t(X0),
        point_prior_info=_t(pinfo))
    params = dict(max_iterations=10, compute_point_info=True,
                  huber_delta=huber)
    want = jax.jit(jba.ba_solve, static_argnames=("params",))(
        jprob, params=jba.BAParams(**params))
    got = tba.ba_solve(tprob, tba.BAParams(**params))
    _close(got.poses.R.numpy(), want.poses.R)
    _close(got.poses.t.numpy(), want.poses.t)
    _close(got.points.numpy(), want.points, atol=1e-3)
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(float(got.error), float(want.error), rtol=1e-3)
    cov_j = np.asarray(want.pose_covariance)[1]
    np.testing.assert_allclose(got.pose_covariance.numpy()[1], cov_j, rtol=0,
                               atol=1e-2 * np.abs(cov_j).max())
    info_j = np.asarray(want.point_information)
    np.testing.assert_allclose(got.point_information.numpy(), info_j,
                               rtol=0, atol=1e-3 * np.abs(info_j).max())


@pytest.fixture(scope="module")
def pnp_scene():
    """World points seen by a camera at t=(0.6, -0.1, 0.2) with a small
    rotation; 0.3 px noise and 15% outliers."""
    rng = np.random.default_rng(13)
    n = 250
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                  rng.uniform(4, 8, n)], 1)
    T = JSE3.exp(jnp.asarray([0.6, -0.1, 0.2, 0.02, -0.03, 0.01]))
    R, t = np.asarray(T.R), np.asarray(T.t)
    Xc = (X - t) @ R
    r = np.c_[Xc[:, :2] / Xc[:, 2:], np.ones(n)]
    r[:, :2] += rng.normal(0, 0.3 / FOCAL, (n, 2))
    out = rng.uniform(size=n) < 0.15
    r[out, :2] += rng.uniform(-0.1, 0.1, (out.sum(), 2))
    mask = rng.uniform(size=n) > 0.1
    return X.astype(np.float32), r.astype(np.float32), mask, R, t


def test_p3p_solve_candidates(pnp_scene):
    X, r, _, R, t = pnp_scene
    rng = np.random.default_rng(14)
    idx = np.stack([rng.choice(len(X), 3, replace=False) for _ in range(64)])
    Xs = X[idx]
    bear = r[idx] / np.linalg.norm(r[idx], axis=-1, keepdims=True)
    pj, vj = jax.jit(jp3p.p3p_solve)(_j(Xs), _j(bear))
    pt, vt = tp3p.p3p_solve(_t(Xs), _t(bear))
    vj, vt = np.asarray(vj), vt.numpy()
    assert vj.sum() > 64
    # candidates are an unordered set of up to 12 (near-duplicate roots may
    # come out in another slot order): every valid JAX pose has a valid
    # port pose within float32 polish accuracy, for 98% of them
    Rj, tj = np.asarray(pj.R), np.asarray(pj.t)
    Rt, tt = pt.R.numpy(), pt.t.numpy()
    found = []
    for h in range(len(idx)):
        for c in np.nonzero(vj[h])[0]:
            d = [np.abs(Rt[h, e] - Rj[h, c]).max() + np.abs(tt[h, e]
                                                            - tj[h, c]).max()
                 for e in np.nonzero(vt[h])[0]]
            found.append(min(d, default=np.inf) < 1e-3)
    assert np.mean(found) > 0.98, np.mean(found)


def test_pnp_ransac_core_same_pose(pnp_scene):
    X, r, mask, R, t = pnp_scene
    key = jax.random.PRNGKey(5)
    thr = (0.75 / FOCAL) ** 2
    core = jax.jit(jpnp.pnp_ransac_core,
                   static_argnames=("num_hypotheses", "thr_sq"))
    pj, inl_j = core(_j(X), _j(r), jnp.asarray(mask), key,
                     num_hypotheses=128, thr_sq=thr)
    u = np.asarray(jax.random.uniform(key, (128, len(X))))
    pt, inl_t = tpnp.pnp_ransac_core(_t(X), _t(r), torch.from_numpy(mask),
                                     128, thr,
                                     uniforms=torch.from_numpy(u.copy()))
    inl_j = np.asarray(inl_j)
    assert inl_j.sum() > 150
    assert np.sum(inl_t.numpy() != inl_j) <= 2
    _close(pt.R.numpy(), pj.R)
    _close(pt.t.numpy(), pj.t)
    # and both found the true pose
    _close(pt.t.numpy(), t, atol=0.02)


def test_pose_dlt_and_refine_gn(pnp_scene):
    X, r, mask, _, _ = pnp_scene
    w = mask.astype(np.float32)
    Rj, tj = jax.jit(jpnp._pose_dlt)(_j(X), _j(r), _j(w))
    Rt, tt = tpnp._pose_dlt(_t(X), _t(r), _t(w))
    s = np.sign(np.sum(Rt.numpy() * np.asarray(Rj)))
    _close(s * Rt.numpy(), Rj, atol=1e-3 * np.abs(np.asarray(Rj)).max())
    pj = jax.jit(jpnp._pose_from_dlt)(Rj, tj, _j(X), _j(w))
    gj = jax.jit(jpnp.refine_pose_gn)(pj, _j(X), _j(r), _j(w))
    gt = tpnp.refine_pose_gn(TSE3(_t(pj.R), _t(pj.t)), _t(X), _t(r), _t(w))
    _close(gt.R.numpy(), gj.R)
    _close(gt.t.numpy(), gj.t)
    _close(tpnp.reprojection_error_sq(gt, _t(X), _t(r)).numpy(),
           jpnp.reprojection_error_sq(gj, _j(X), _j(r)), atol=1e-6)


def test_pinhole_camera_matches():
    """Projection, depths and normalisation of a posed camera; float32
    3x3 products in both packages, so agreement to float32 rounding."""
    rng = np.random.default_rng(7)
    xi = rng.normal(scale=0.2, size=6)
    X = rng.normal(size=(50, 3)) + np.array([0.0, 0.0, 6.0])
    uv = rng.uniform(0, 300, size=(50, 2))
    args = (FOCAL, FOCAL * 1.01, 0.5, 191.5, 143.5)
    cj = jcam.PinholeCamera.from_params(*args, P=JSE3.exp(_j(xi)))
    ct = tcam.PinholeCamera.from_params(*args, P=TSE3.exp(_t(xi)))
    _close(ct.K_inv.numpy(), cj.K_inv, atol=1e-7)
    _close(ct.project_points(_t(X)).numpy(), cj.project_points(_j(X)),
           atol=1e-3)
    _close(ct.point_depths(_t(X)).numpy(), cj.point_depths(_j(X)),
           atol=1e-5)
    _close(ct.normalize_points(_t(uv)).numpy(), cj.normalize_points(_j(uv)),
           atol=1e-6)
