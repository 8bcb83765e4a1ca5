"""The JAX package's own two-view, PnP and bundle-adjustment bars, rerun on
the port: ``tests/test_sfm.py`` and ``tests/test_ba.py`` on
``mvslam_tpu_torch.ops.{epipolar,ransac,sfm,triangulate,p3p,pnp,ba}``, in
float64 and float32, on the reference's CUBE / L_SHAPE rigs
(``tests/helpers.py``) with its ``tol_for`` (1e-3 in float64, 5e-3 in
float32) and its noise, seeds and outliers.

The inputs are built in the working type with torch, as the reference
builds them with JAX, and handed to both packages. Where a JAX case takes a
PRNG key, the port gets the uniforms that key draws
(``jax.random.uniform(key, (hypotheses, N))``, as ``ransac.py`` draws
them) through ``uniforms=``, so both solve the same minimal sets; the port
is then also held to the JAX result on the same inputs, within the case's
own bar. (a) rerun here; (b) an existing test already asserts the bar;
(c) not applicable.

| reference case | | where |
|---|---|---|
| `test_sfm.py::test_essential_matrix_epipolar_constraint` | a | `test_essential_matrix_epipolar_constraint` |
| `test_sfm.py::test_fundamental_matrix_pixel_points` | a | `test_fundamental_matrix_pixel_points` |
| `test_sfm.py::test_sfm_solve_recovers_pose_and_points` | a | `test_sfm_solve_recovers_pose_and_points` |
| `test_sfm.py::test_sfm_solve_rejects_outliers` | a | `test_sfm_solve_rejects_outliers` |
| `test_sfm.py::test_sfm_triangulate_known_pose` | a | `test_sfm_triangulate_known_pose` |
| `test_sfm.py::test_triangulate_rejects_behind_camera` | a | `test_triangulate_rejects_behind_camera` |
| `test_sfm.py::test_sample_minimal_sets_distinct_and_valid` | a | `test_sample_minimal_sets_distinct_and_valid` (the port's own generator; JAX's indices from its key: `test_torch_geometry.py::test_sample_minimal_sets_same_indices`) |
| `test_sfm.py::test_sfm_solve_jits_and_caches` | a | `test_sfm_solve_succeeds_under_two_generators` (no `jax.jit` in the port: what it asserts, padded inputs solved under two draws) |
| `test_sfm.py::test_fundamental_ransac_pixel_space` | a | `test_fundamental_ransac_pixel_space` |
| (repair) | | `test_a_refit_whose_eigh_fails_keeps_the_hypothesis`: the refit's eigh no longer raises where JAX returns NaN |
| (port) | | `test_essential_ransac_is_its_pieces_composed`: the pieces the tracker's bootstrap replays between its `eigh` calls |
| `test_ba.py::test_sfm_refine_noiseless_stays_exact` | a | `test_sfm_refine_noiseless_stays_exact` |
| `test_ba.py::test_sfm_refine_recovers_under_noise` | a | `test_sfm_refine_recovers_under_noise` |
| `test_ba.py::test_ba_cost_decreases_and_masks_ignored` | a | `test_ba_cost_decreases_and_masks_ignored` |
| `test_ba.py::test_ba_huber_caps_gross_outlier` | a | `test_ba_huber_caps_gross_outlier` |
| `test_ba.py::test_pnp_solve_exact` | a | `test_pnp_solve_exact` |
| `test_ba.py::test_pnp_solve_with_outliers` | a | `test_pnp_solve_with_outliers` |
| `test_ba.py::test_pnp_solve_planar_scene` | a | `test_pnp_solve_planar_scene` |
| `test_ba.py::test_p3p_candidates_contain_truth` | a | `test_p3p_candidates_contain_truth` |
| `test_ba.py::test_pnp_refine_under_noise` | a | `test_pnp_refine_under_noise` |
| `test_ba.py::test_ba_solve_jits` | a | `test_sfm_refine_converges` (no `jax.jit` in the port: what it asserts, the refine converges) |
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.math.lie import SE3 as JSE3
from mvslam_tpu.ops import ba as jba
from mvslam_tpu.ops import epipolar as jep
from mvslam_tpu.ops import p3p as jp3p
from mvslam_tpu.ops import pnp as jpnp
from mvslam_tpu.ops import ransac as jrs
from mvslam_tpu.ops import sfm as jsfm
from mvslam_tpu_torch.math import linalg
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops import ba, epipolar, p3p, pnp, ransac, sfm
from mvslam_tpu_torch.ops import triangulate

from helpers import _RIGS, CUBE, L_SHAPE
from test_torch_ref_common import (DTYPES, Dt, max_abs, project_ideal,
                                   random_se3, rig, rpy, se3)
from test_torch_ref_common import one_torch_thread  # noqa: F401 (autouse)

NOISE_STD = 5e-3          # test_ba.py
NOISY_TOL = 2.5e-2        # test_ba.py


@pytest.fixture(params=DTYPES)
def dt(request):
    return Dt(request.param)


def jax_uniforms(seed: int, hypotheses: int, n: int) -> torch.Tensor:
    """What ``jax.random.PRNGKey(seed)`` draws for a RANSAC of ``n``."""
    u = jax.random.uniform(jax.random.PRNGKey(seed), (hypotheses, n))
    return torch.from_numpy(np.array(u))


def jse3(T: SE3, dt: Dt) -> JSE3:
    return JSE3(dt.j(T.R), dt.j(T.t))


def pose_err(T: SE3, T_gt: SE3) -> float:
    return float(torch.max(torch.abs(T.log() - T_gt.log())))


def jpose_err(T_jax, T: SE3) -> float:
    """Componentwise |ln| distance between a JAX and a port pose."""
    return max_abs(T_jax.log(), T.log().numpy())


sfm_solve_j = jax.jit(jsfm.sfm_solve, static_argnames=("params",))
sfm_refine_j = jax.jit(jsfm.sfm_refine, static_argnames=("ba_params",))
pnp_solve_j = jax.jit(jpnp.pnp_solve, static_argnames=("params",))
pnp_refine_j = jax.jit(jpnp.pnp_refine)
p3p_solve_j = jax.jit(jp3p.p3p_solve)
triangulate_j = jax.jit(jsfm.sfm_triangulate)
essential_j = jax.jit(jep.find_essential_matrix)
fundamental_j = jax.jit(jep.find_fundamental_matrix)
fundamental_ransac_j = jax.jit(jrs.fundamental_ransac,
                               static_argnames=("max_error",))


# -- tests/test_sfm.py ------------------------------------------------------


def two_view_fixture(rig_type, dt: Dt, n_pad=0):
    """The rig in front of camera 1 (origin), camera 2 at +x."""
    points = dt.t(rig(rig_type))
    pose2in1 = se3(np.eye(3), [1.0, 0.0, 0.0], dt)
    r1 = project_ideal(SE3.identity(dtype=dt.torch), points)
    r2 = project_ideal(pose2in1, points)
    mask = torch.ones(points.shape[0], dtype=torch.bool)
    if n_pad:
        pad = torch.zeros((n_pad, 3), dtype=dt.torch)
        r1, r2, points = (torch.cat([a, pad]) for a in (r1, r2, points))
        mask = torch.cat([mask, torch.zeros(n_pad, dtype=torch.bool)])
    return points, pose2in1, r1, r2, mask


@pytest.mark.parametrize("rig_type", [CUBE, L_SHAPE])
def test_essential_matrix_epipolar_constraint(rig_type, dt):
    _, _, r1, r2, mask = two_view_fixture(rig_type, dt)
    E = epipolar.find_essential_matrix(r1, r2, mask.to(dt.torch))
    assert float(torch.max(epipolar.epipolar_residual(E, r1, r2))) < dt.tol
    E_j = np.asarray(essential_j(dt.j(r1), dt.j(r2), dt.j(mask.numpy())))
    sign = np.sign(np.sum(E.numpy() * E_j))
    assert max_abs(sign * E.numpy(), E_j) < dt.tol


def test_fundamental_matrix_pixel_points(dt):
    _, _, r1, r2, mask = two_view_fixture(CUBE, dt)
    K = dt.t([[350.0, 0.0, 192.0], [0.0, 350.0, 144.0], [0, 0, 1.0]])
    p1, p2 = (r1 @ K.T)[:, :2], (r2 @ K.T)[:, :2]
    F = epipolar.find_fundamental_matrix(p1, p2, mask.to(dt.torch))
    ones = torch.ones_like(p1[:, :1])
    h1, h2 = torch.cat([p1, ones], -1), torch.cat([p2, ones], -1)
    res = torch.abs(torch.sum(h2 * (h1 @ F.T), dim=-1))
    assert float(torch.max(res)) < 100 * dt.tol
    s = torch.linalg.svdvals(F.to(torch.float64))
    assert float(s[2]) < 100 * dt.tol
    F_j = np.asarray(fundamental_j(dt.j(p1), dt.j(p2), dt.j(mask.numpy())))
    sign = np.sign(np.sum(F.numpy() * F_j))
    assert max_abs(sign * F.numpy(), F_j) < 100 * dt.tol


@pytest.mark.parametrize("rig_type", [CUBE, L_SHAPE])
def test_sfm_solve_recovers_pose_and_points(rig_type, dt):
    points, pose2in1, r1, r2, mask = two_view_fixture(rig_type, dt, n_pad=8)
    u = jax_uniforms(0, sfm.SfmParams().num_hypotheses, 16)
    result = sfm.sfm_solve(r1, r2, mask, uniforms=u)
    assert bool(result.success)
    assert pose_err(result.pose2in1, pose2in1) < dt.tol
    pm = result.point_mask
    assert bool(pm[:8].all())
    assert float(torch.max(torch.abs(result.points - points)[pm])) \
        < 10 * dt.tol
    want = sfm_solve_j(dt.j(r1), dt.j(r2), jnp.asarray(mask.numpy()),
                       jax.random.PRNGKey(0))
    np.testing.assert_array_equal(result.inlier_mask.numpy(),
                                  np.asarray(want.inlier_mask))
    assert jpose_err(want.pose2in1, result.pose2in1) < dt.tol


def test_sfm_solve_rejects_outliers(dt):
    rng = np.random.default_rng(7)
    n_in, n_out = 48, 16
    pts = dt.t(np.c_[rng.uniform(-2, 2, (n_in, 2)), rng.uniform(4, 9, n_in)])
    pose2in1 = se3(rpy(0.02, -0.01, 0.03), [0.8, -0.36, 0.48], dt)
    r1 = project_ideal(SE3.identity(dtype=dt.torch), pts)
    r2 = project_ideal(pose2in1, pts)
    r2[n_in - n_out:, :2] += dt.t(rng.uniform(-0.5, 0.5, (n_out, 2)))
    mask = torch.ones(n_in, dtype=torch.bool)
    params = sfm.SfmParams(num_hypotheses=512, threshold_sq=1e-4)
    result = sfm.sfm_solve(r1, r2, mask, params,
                           uniforms=jax_uniforms(3, 512, n_in))
    inl = result.inlier_mask.numpy()
    assert inl[: n_in - n_out].all()
    assert not inl[n_in - n_out:].any()
    t_gt = pose2in1.t / torch.linalg.vector_norm(pose2in1.t)
    assert pose_err(result.pose2in1, SE3(pose2in1.R, t_gt)) < 10 * dt.tol
    want = sfm_solve_j(dt.j(r1), dt.j(r2), jnp.asarray(mask.numpy()),
                       jax.random.PRNGKey(3),
                       jsfm.SfmParams(num_hypotheses=512, threshold_sq=1e-4))
    np.testing.assert_array_equal(inl, np.asarray(want.inlier_mask))
    assert jpose_err(want.pose2in1, result.pose2in1) < 10 * dt.tol


@pytest.mark.parametrize("refit", [True, False])
def test_essential_ransac_is_its_pieces_composed(dt, refit):
    """``ransac.essential_ransac`` is its pieces in order, bit for bit: the
    hypotheses and their best, per IRLS refit the Gram matrix, one
    ``linalg.eigh`` and the solve after it, then the keep test (the split
    that the tracker's bootstrap replays as CUDA graphs between its eager
    ``eigh`` calls). The eigh path of ``find_essential_matrix`` is likewise
    its Gram matrix, ``eigh`` and the solve after it. On
    ``test_sfm_solve_rejects_outliers``' rays, where the refits move."""
    rng = np.random.default_rng(7)
    n_in, n_out = 48, 16
    pts = dt.t(np.c_[rng.uniform(-2, 2, (n_in, 2)), rng.uniform(4, 9, n_in)])
    pose2in1 = se3(rpy(0.02, -0.01, 0.03), [0.8, -0.36, 0.48], dt)
    r1 = project_ideal(SE3.identity(dtype=dt.torch), pts)
    r2 = project_ideal(pose2in1, pts)
    r2[n_in - n_out:, :2] += dt.t(rng.uniform(-0.5, 0.5, (n_out, 2)))
    mask = torch.ones(n_in, dtype=torch.bool)
    mask[5] = False
    u, thr = jax_uniforms(3, 256, n_in), 1e-4
    got = ransac.essential_ransac(r1, r2, mask, 256, thr, refit=refit,
                                  uniforms=u)
    E, inl = ransac.essential_hypotheses(r1, r2, mask, 256, thr, uniforms=u)
    if refit:
        E_fit, inl_fit = E, inl
        for _ in range(ransac.ESSENTIAL_REFITS):
            w, gram = ransac.refit_gram(E_fit, inl_fit, r1, r2)
            V = linalg.eigh(gram)[1]
            E_fit, inl_fit = ransac.refit_solve(V, w, r1, r2, mask, thr)
            same = epipolar.find_essential_matrix(r1, r2, w, use_eigh=True)
            assert torch.equal(same, epipolar.essential_of_eigvecs(
                linalg.eigh(epipolar.essential_gram(r1, r2, w))[1], r1, r2,
                w))
            assert torch.equal(same, E_fit)
        want = ransac.keep_refit(E, inl, E_fit, inl_fit, r1, r2)
    else:
        want = ransac.essential_result(E, inl, r1, r2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got.num_inliers) >= n_in - n_out - 1


@pytest.mark.parametrize("rig_type", [CUBE, L_SHAPE])
def test_sfm_triangulate_known_pose(rig_type, dt):
    points, pose2in1, r1, r2, mask = two_view_fixture(rig_type, dt)
    X, pm = sfm.sfm_triangulate(r1, r2, mask, pose2in1)
    assert bool(pm.all())
    assert float(torch.max(torch.abs(X - points))) < 10 * dt.tol
    X_j, _ = triangulate_j(dt.j(r1), dt.j(r2), jnp.asarray(mask.numpy()),
                           jse3(pose2in1, dt))
    assert max_abs(X.numpy(), X_j) < 10 * dt.tol


def test_a_refit_whose_eigh_fails_keeps_the_hypothesis(dt, monkeypatch):
    """Repaired in the port: on the card the float32 refit of this case's
    exact rays made cuSOLVER's 9x9 eigh report no convergence (as does the
    LAPACK build of some hosts), and torch raised where
    ``jnp.linalg.eigh`` returns NaN, so ``sfm_solve`` failed the
    reference's own case. With ``linalg.eigh`` the refit comes out NaN, is
    dropped, and the minimal hypothesis is kept, as in JAX. Forced here by
    making every eigh fail in both packages."""
    _, pose2in1, r1, r2, mask = two_view_fixture(CUBE, dt, n_pad=8)
    u = jax_uniforms(0, 256, 16)
    thr = sfm.SfmParams().threshold_sq
    kept = ransac.essential_ransac(r1, r2, mask, 256, thr, refit=False,
                                   uniforms=u)

    def no_convergence(*args, **kwargs):
        raise torch.linalg.LinAlgError("forced")

    def nan_eigh(a, *args, **kwargs):
        return jnp.full(a.shape[:-1], jnp.nan, a.dtype), jnp.full_like(
            a, jnp.nan)

    monkeypatch.setattr(torch.linalg, "eigh", no_convergence)
    monkeypatch.setattr(jnp.linalg, "eigh", nan_eigh)
    got = ransac.essential_ransac(r1, r2, mask, 256, thr, uniforms=u)
    np.testing.assert_array_equal(got.model.numpy(), kept.model.numpy())
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  kept.inlier_mask.numpy())
    # traced here, under the patch (a new function, so no cached trace)
    want = jax.jit(lambda a, b, m: jrs.essential_ransac(
        a, b, m, jax.random.PRNGKey(0), 256, thr))(
        dt.j(r1), dt.j(r2), jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  np.asarray(want.inlier_mask))
    sign = np.sign(np.sum(got.model.numpy() * np.asarray(want.model)))
    assert max_abs(sign * got.model.numpy(), want.model) < dt.tol
    res = sfm.sfm_solve(r1, r2, mask, uniforms=u)
    assert bool(res.success)
    assert pose_err(res.pose2in1, pose2in1) < dt.tol


def test_triangulate_rejects_behind_camera(dt):
    P1 = torch.cat([torch.eye(3, dtype=dt.torch),
                    torch.zeros((3, 1), dtype=dt.torch)], -1)
    P2 = se3(np.eye(3), [1.0, 0.0, 0.0], dt).inverse().matrix3x4()
    X = dt.t([[0.0, 0.0, -5.0]])
    assert not bool(triangulate.cheirality_mask(P1, P2, X)[0])


def test_sample_minimal_sets_distinct_and_valid():
    mask = torch.arange(64) < 20
    idx = ransac.sample_minimal_sets(
        mask, 128, 8, generator=torch.Generator().manual_seed(1)).numpy()
    assert idx.shape == (128, 8)
    assert (idx < 20).all()
    for row in idx:
        assert len(set(row.tolist())) == 8


def test_sfm_solve_succeeds_under_two_generators(dt):
    _, _, r1, r2, mask = two_view_fixture(CUBE, dt, n_pad=8)
    for seed in (0, 42):
        r = sfm.sfm_solve(r1, r2, mask,
                          generator=torch.Generator().manual_seed(seed))
        assert bool(r.success), seed


def test_fundamental_ransac_pixel_space(dt, rng):
    n_in, n_out = 40, 12
    pts = dt.t(np.c_[rng.uniform(-2, 2, (n_in + n_out, 2)),
                     rng.uniform(4, 9, n_in + n_out)])
    pose2in1 = se3(rpy(0.05, -0.03, 0.02), [1.0, 0.1, -0.05], dt)
    r1 = pts / pts[:, 2:3]
    p_cam2 = pose2in1.inverse().apply(pts)
    r2 = p_cam2 / p_cam2[:, 2:3]
    K = dt.t([[350.0, 0, 192.0], [0, 350.0, 144.0], [0, 0, 1.0]])
    p1, p2 = (r1 @ K.T)[:, :2], (r2 @ K.T)[:, :2]
    p2[n_in:] += dt.t(rng.uniform(30, 80, (n_out, 2)))
    mask = torch.ones(n_in + n_out, dtype=torch.bool)
    res = ransac.fundamental_ransac(p1, p2, mask, max_error=1e-3,
                                    uniforms=jax_uniforms(3, 256, 52))
    inl = res.inlier_mask.numpy()
    assert inl[:n_in].all()
    assert not inl[n_in:].any()
    assert float(torch.linalg.svdvals(res.model.to(torch.float64))[2]) < 1e-4
    want = fundamental_ransac_j(dt.j(p1), dt.j(p2), jnp.asarray(mask.numpy()),
                                jax.random.PRNGKey(3), max_error=1e-3)
    np.testing.assert_array_equal(inl, np.asarray(want.inlier_mask))


# -- tests/test_ba.py -------------------------------------------------------


def two_view_setup(rig_type, dt: Dt):
    points = dt.t(rig(rig_type))
    pose2in1 = se3(rpy(0.05, -0.03, 0.02), [1.0, 0.1, -0.05], dt)
    r1 = project_ideal(SE3.identity(dtype=dt.torch), points)
    r2 = project_ideal(pose2in1, points)
    mask = torch.ones(points.shape[0], dtype=torch.bool)
    return points, pose2in1, r1, r2, mask


def refine_both(dt, r1, r2, mask, pose, points, ba_params=None):
    """``sfm_refine`` of the port and of JAX on the same inputs."""
    kw = dict(obs_stddev=NOISE_STD)
    got = sfm.sfm_refine(r1, r2, mask, pose, points,
                         ba_params=ba_params or ba.BAParams(), **kw)
    want = sfm_refine_j(dt.j(r1), dt.j(r2), jnp.asarray(mask.numpy()),
                        jse3(pose, dt), dt.j(points),
                        ba_params=jba.BAParams(
                            **(ba_params or ba.BAParams())._asdict()), **kw)
    return got, want


@pytest.mark.parametrize("rig_type", [CUBE, L_SHAPE])
def test_sfm_refine_noiseless_stays_exact(rig_type, dt):
    points, pose2in1, r1, r2, mask = two_view_setup(rig_type, dt)
    res, want = refine_both(dt, r1, r2, mask, pose2in1, points)
    assert pose_err(res.pose2in1, pose2in1) < dt.tol
    assert float(torch.max(torch.abs(res.points - points))) < 10 * dt.tol
    assert bool(res.converged)
    assert jpose_err(want.pose2in1, res.pose2in1) < dt.tol
    assert bool(want.converged)


@pytest.mark.parametrize("rig_type", [CUBE, L_SHAPE])
def test_sfm_refine_recovers_under_noise(rig_type, dt):
    rng = np.random.default_rng(0)
    points, pose2in1, r1, r2, mask = two_view_setup(rig_type, dt)
    r1n, r2n = r1.clone(), r2.clone()
    r1n[:, :2] += dt.t(rng.normal(0, NOISE_STD, (8, 2)))
    r2n[:, :2] += dt.t(rng.normal(0, NOISE_STD, (8, 2)))
    pose_init = pose2in1.compose(random_se3(rng, 0.02, dt))
    points_init = points + dt.t(rng.normal(0, 0.02, (8, 3)))
    res, want = refine_both(dt, r1n, r2n, mask, pose_init, points_init)
    assert pose_err(res.pose2in1, pose2in1) < NOISY_TOL
    assert float(torch.max(torch.abs(res.points - points))) < 2 * NOISY_TOL
    pc = res.pose_covariance.numpy().astype(np.float64)
    assert np.allclose(pc, pc.T, atol=1e-8)
    assert (np.linalg.eigvalsh(pc) > 0).all()
    xc = res.point_covariance.numpy().astype(np.float64)
    assert (np.linalg.eigvalsh(xc) > -1e-12).all()
    assert jpose_err(want.pose2in1, res.pose2in1) < NOISY_TOL


def test_ba_cost_decreases_and_masks_ignored(dt):
    points, pose2in1, r1, r2, mask = two_view_setup(CUBE, dt)
    r1g = torch.cat([r1, torch.full((4, 3), 1e3, dtype=dt.torch)])
    r2g = torch.cat([r2, torch.full((4, 3), -1e3, dtype=dt.torch)])
    maskg = torch.cat([mask, torch.zeros(4, dtype=torch.bool)])
    pts_g = torch.cat([points, torch.zeros((4, 3), dtype=dt.torch)])
    res, want = refine_both(dt, r1g, r2g, maskg, pose2in1, pts_g)
    assert pose_err(res.pose2in1, pose2in1) < dt.tol
    assert jpose_err(want.pose2in1, res.pose2in1) < dt.tol


def test_ba_huber_caps_gross_outlier(dt):
    points, pose2in1, r1, r2, mask = two_view_setup(CUBE, dt)
    r2_bad = r2.clone()
    r2_bad[2, 0] += 40.0 * NOISE_STD
    res_plain, _ = refine_both(dt, r1, r2_bad, mask, pose2in1, points)
    res_huber, want = refine_both(dt, r1, r2_bad, mask, pose2in1, points,
                                  ba.BAParams(huber_delta=2.0))
    err_plain = pose_err(res_plain.pose2in1, pose2in1)
    err_huber = pose_err(res_huber.pose2in1, pose2in1)
    assert err_huber < err_plain, (err_huber, err_plain)
    assert err_huber < NOISY_TOL, err_huber
    assert jpose_err(want.pose2in1, res_huber.pose2in1) < NOISY_TOL


def pnp_both(dt, X, r, mask, seed, params=pnp.PnpParams()):
    """``pnp_solve`` of the port (on the uniforms of JAX's key) and of
    JAX."""
    got = pnp.pnp_solve(X, r, mask, params,
                        uniforms=jax_uniforms(seed, params.num_hypotheses,
                                              X.shape[0]))
    want = pnp_solve_j(dt.j(X), dt.j(r), jnp.asarray(mask.numpy()),
                       jax.random.PRNGKey(seed),
                       jpnp.PnpParams(**params._asdict()))
    np.testing.assert_array_equal(got.inlier_mask.numpy(),
                                  np.asarray(want.inlier_mask))
    return got, want


def pnp_setup(rig_type, dt):
    points = dt.t(rig(rig_type))
    pose = se3(rpy(-0.04, 0.06, 0.1), [0.4, -0.2, 0.3], dt)
    return points, pose, project_ideal(pose, points)


@pytest.mark.parametrize("rig_type", [CUBE, L_SHAPE])
def test_pnp_solve_exact(rig_type, dt):
    points, pose, r = pnp_setup(rig_type, dt)
    mask = torch.ones(8, dtype=torch.bool)
    res, want = pnp_both(dt, points, r, mask, 0)
    assert bool(res.success)
    assert int(res.num_inliers) == 8
    assert pose_err(res.pose, pose) < dt.tol
    assert jpose_err(want.pose, res.pose) < dt.tol


def test_pnp_solve_with_outliers(dt, rng):
    n_in, n_out = 40, 14
    pts = dt.t(np.c_[rng.uniform(-2, 2, (n_in + n_out, 2)),
                     rng.uniform(4, 9, n_in + n_out)])
    pose = se3(rpy(0.1, 0.05, -0.07), [0.5, -0.3, 0.2], dt)
    r = project_ideal(pose, pts)
    r[n_in:, :2] += dt.t(rng.uniform(0.2, 0.6, (n_out, 2)))
    mask = torch.ones(n_in + n_out, dtype=torch.bool)
    res, want = pnp_both(dt, pts, r, mask, 5,
                         pnp.PnpParams(num_hypotheses=512, threshold=0.01))
    inl = res.inlier_mask.numpy()
    assert inl[:n_in].all()
    assert not inl[n_in:].any()
    assert pose_err(res.pose, pose) < 10 * dt.tol
    assert jpose_err(want.pose, res.pose) < 10 * dt.tol


def test_pnp_solve_planar_scene(dt, rng):
    n = 24
    xy = rng.uniform(-2.0, 2.0, (n, 2))
    pts = dt.t(np.c_[xy, np.full(n, 5.0)])
    pose = se3(rpy(0.12, -0.08, 0.2), [0.3, -0.1, 0.4], dt)
    r = project_ideal(pose, pts)
    mask = torch.ones(n, dtype=torch.bool)
    res, want = pnp_both(dt, pts, r, mask, 2)
    assert bool(res.success)
    assert int(res.num_inliers) == n
    assert pose_err(res.pose, pose) < dt.tol
    assert jpose_err(want.pose, res.pose) < dt.tol


def test_p3p_candidates_contain_truth(dt):
    pts = dt.t(rig(L_SHAPE)[:3])
    pose = se3(rpy(-0.04, 0.06, 0.1), [0.4, -0.2, 0.3], dt)
    r = project_ideal(pose, pts)
    bear = r / torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    cand, valid = p3p.p3p_solve(pts[None], bear[None])
    d = torch.amax(torch.abs(cand.log() - pose.log()[None, None]), dim=-1)
    d = torch.where(valid, d, torch.full_like(d, float("inf")))
    assert bool(valid.any())
    assert float(torch.min(d)) < dt.tol
    # JAX's nearest valid candidate is the port's: which of the other
    # roots count as valid hangs on float32 rounding of a discriminant
    # near zero, which XLA's fused order and torch's move differently
    cand_j, valid_j = p3p_solve_j(dt.j(pts)[None], dt.j(bear)[None])
    d_j = np.where(np.asarray(valid_j), np.max(np.abs(
        np.asarray(cand_j.log()) - pose.log().numpy()), axis=-1), np.inf)
    best, best_j = int(torch.argmin(d)), int(np.argmin(d_j))
    assert max_abs(cand.log().reshape(-1, 6)[best],
                   np.asarray(cand_j.log()).reshape(-1, 6)[best_j]) < dt.tol


def test_pnp_refine_under_noise(dt, rng):
    points, pose, r = pnp_setup(CUBE, dt)
    r[:, :2] += dt.t(rng.normal(0, NOISE_STD, (8, 2)))
    mask = torch.ones(8, dtype=torch.bool)
    pose_init = pose.compose(random_se3(rng, 0.02, dt))
    reg_info = 1e4 * torch.eye(6, dtype=dt.torch)
    point_info = ((1.0 / NOISE_STD ** 2) * torch.eye(3, dtype=dt.torch)
                  ).expand(8, 3, 3)
    obs_weight = torch.full((8,), 1.0 / NOISE_STD, dtype=dt.torch)
    refined, cov, _ = pnp.pnp_refine(pose_init, reg_info, points, point_info,
                                     r, obs_weight=obs_weight, mask=mask)
    assert pose_err(refined, pose) < NOISY_TOL
    c = cov.numpy().astype(np.float64)
    assert (np.linalg.eigvalsh(c) > 0).all()
    want, _, _ = pnp_refine_j(
        jse3(pose_init, dt), dt.j(reg_info), dt.j(points), dt.j(point_info),
        dt.j(r), obs_weight=dt.j(obs_weight), mask=jnp.asarray(mask.numpy()))
    assert jpose_err(want, refined) < NOISY_TOL


def test_sfm_refine_converges(dt):
    points, pose2in1, r1, r2, mask = two_view_setup(CUBE, dt)
    res = sfm.sfm_refine(r1, r2, mask, pose2in1, points,
                         obs_stddev=NOISE_STD)
    assert bool(res.converged)


def test_the_smoke_run_solves_the_same_rigs(dt):
    """``chip_smoke.py``'s reference-bars phase solves these rigs on the
    card with its own copy of them and of ``tol_for``; its solves meet the
    bars on the CPU."""
    import chip_smoke as cs

    for name, rig_type in (("cube", CUBE), ("l_shape", L_SHAPE)):
        np.testing.assert_array_equal(cs.RIGS[name], _RIGS[rig_type])
        np.testing.assert_allclose(cs.rig_points(cs.RIGS[name]),
                                   rig(rig_type), rtol=0, atol=1e-15)
    assert cs.GEOM_TOL[dt.torch] == dt.tol
    rng = np.random.default_rng(5)
    uniforms = {"sfm": rng.uniform(size=(256, 16)),
                "pnp": rng.uniform(size=(256, 8))}
    for rig_points in cs.RIGS.values():
        got = cs.geometry_errors(torch.device("cpu"), dt.torch, rig_points,
                                 uniforms)
        for solver, (e_pose, e_pts, _) in got.items():
            assert e_pose < dt.tol and e_pts < 10 * dt.tol, solver
