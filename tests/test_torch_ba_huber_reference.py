"""The port's BA with the Huber kernel (``ops/ba.ba_solve`` with
``huber_delta``, as the KITTI deployment runs it) against the plain
reference ``slambench/reference_ba.py`` (dense Levenberg-Marquardt in
float64, Huber by IRLS, no Schur step), on seeded two-frame problems laid
out as the tracker's BA lays them out: the first pose pinned by a prior,
map points with an information prior, fresh points seen from both frames,
and gross outliers planted in the new frame's observations. Both run the
tracker's ten iterations from the same start. The control: the same
problems solved by the port without the kernel lie outside the
tolerances. And ``ba.huber_share`` against the reference's count."""

import functools
import math

import numpy as np
import pytest
import torch

from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops import ba

from slambench import reference_ba as rb
from test_torch_ref_common import one_torch_thread  # noqa: F401

#: ORB-SLAM2's deltaMono = sqrt(5.991), the KITTI configuration's
HUBER = 2.4477
FOCAL = 718.856
SEEDS = range(4)
ITERATIONS = 10            # the tracker's ``ba_iterations``
POINTS, OLD = 48, 36       # points per problem, of which map points
#: (rot rad, trans / baseline, point in sigmas, point / depth, cost / the
#: reference's - 1) the port may lie from the reference. float64: the two
#: take the same steps in exact arithmetic (the prior's Jacobian is the
#: identity in the port and exact here, equal at the pinned pose),
#: measured at most 2.4e-14 rad, 2.0e-12, 7.1e-10 sigma, 6.7e-9 and
#: 3.6e-13. float32: the port's float32 sums move its accept / refuse
#: comparisons near a tie and end one seed at a neighbouring iterate,
#: measured at most 2.5e-5 rad, 2.1e-3, 0.46 sigma, 0.55 and 1.0e-4; the
#: control (no Huber) lies at least 6.7e-3 rad, 0.55, 26.8 sigma, 0.27
#: and 0.35 away. The fresh points, seen from a 0.12 baseline, are loose
#: along their rays: in float32 their depth is held in sigmas, not by
#: the share of their depth
TOL = {"float64": rb.Gaps(1e-10, 1e-9, 1e-6, 1e-6, 1e-9),
       "float32": rb.Gaps(1e-3, 0.05, 3.0, math.inf, 1e-3)}


def _rot(w) -> np.ndarray:
    return SE3.exp(torch.tensor(np.r_[0.0, 0.0, 0.0, w])).R.numpy()


def problem(seed: int, dtype=torch.float64) -> ba.BAProblem:
    """A two-frame problem: the true poses and points observed with
    0.25-1 px of noise, a tenth of the new frame's observations moved by
    10-30 px, a twentieth of the map points' observations masked; the
    start is the truth perturbed, and the priors are the start (the first
    pose pinned at 1e10, the map points at 0.05 units)."""
    rng = np.random.default_rng(seed)
    R = np.stack([_rot(rng.normal(0, 0.01, 3)), _rot(rng.normal(0, 0.01, 3))])
    t = np.stack([np.zeros(3), np.array([0.12, 0.01, 0.02])])
    X = np.c_[rng.uniform(-4, 4, POINTS), rng.uniform(-1.5, 1.5, POINTS),
              rng.uniform(5, 20, POINTS)]
    sig_px = rng.uniform(0.25, 1.0, (2, POINTS))
    obs = np.zeros((2, POINTS, 2))
    for f in range(2):
        Xc = (X - t[f]) @ R[f]
        obs[f] = (Xc[:, :2] / Xc[:, 2:]
                  + rng.normal(0, 1, (POINTS, 2)) * sig_px[f, :, None] / FOCAL)
    bad = rng.random((2, POINTS)) < 0.1
    bad[0] = False
    n_bad = int(bad.sum())
    obs[bad] += (rng.uniform(10, 30, (n_bad, 2))
                 * rng.choice([-1, 1], (n_bad, 2)) / FOCAL)
    mask = rng.random((2, POINTS)) > 0.05
    mask[:, OLD:] = True
    R0, t0 = R.copy(), t.copy()
    R0[1] = R[1] @ _rot(rng.normal(0, 0.002, 3))
    t0[1] = t[1] + rng.normal(0, 0.01, 3)
    X0 = X + rng.normal(0, 0.05, X.shape)
    info = np.zeros((POINTS, 3, 3))
    info[:OLD] = np.eye(3) / 0.05 ** 2
    pose_info = np.zeros((2, 6, 6))
    pose_info[0] = 1e10 * np.eye(6)

    def T(a):
        return torch.tensor(a, dtype=dtype)

    poses0 = SE3(T(R0), T(t0))
    return ba.BAProblem.create(
        poses0, T(X0), T(obs), torch.tensor(mask), T(FOCAL / sig_px),
        pose_prior=poses0, pose_prior_info=T(pose_info), point_prior=T(X0),
        point_prior_info=T(info))


def port_solve(prob: ba.BAProblem, huber_delta):
    """The port's solve with the tracker's BA settings."""
    return ba.ba_solve(prob, ba.BAParams(
        max_iterations=ITERATIONS, compute_covariance=False,
        compute_point_info=True, huber_delta=huber_delta))


@functools.lru_cache(maxsize=None)
def reference(seed: int):
    """The reference's problem, solve and point information for ``seed``."""
    prob = rb.from_port(problem(seed))
    ref = rb.solve(prob, HUBER, max_iterations=ITERATIONS)
    return prob, ref, rb.point_information(prob, ref, HUBER)


def _gaps(seed: int, dtype: str, huber_delta) -> rb.Gaps:
    prob, ref, info = reference(seed)
    res = port_solve(problem(seed, getattr(torch, dtype)), huber_delta)
    return rb.gaps(res.poses.R, res.poses.t, res.points, ref, prob, info,
                   HUBER)


def _within(g: rb.Gaps, tol: rb.Gaps) -> bool:
    return all(a <= b for a, b in zip(g, tol))


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("seed", SEEDS)
def test_huber_solve_matches_the_reference(seed, dtype):
    g = _gaps(seed, dtype, HUBER)
    assert _within(g, TOL[dtype]), g


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("seed", SEEDS)
def test_control_without_huber_misses_the_reference(seed, dtype):
    """The planted outliers pull a Gaussian solve away: the port without
    the kernel lies outside every finite tolerance."""
    g = _gaps(seed, dtype, None)
    assert all(a > b for a, b in zip(g, TOL[dtype]) if b < math.inf), g


@pytest.mark.parametrize("seed", SEEDS)
def test_huber_share_counts_what_the_reference_counts(seed):
    """At the reference's result, the port's share of observations past
    the delta is the reference's; the planted outliers are among them;
    without a delta it is 0."""
    prob, ref, _ = reference(seed)
    port = problem(seed)
    got = ba.huber_share(SE3(ref.R, ref.t), ref.points, port, HUBER)
    want = rb.robust_share(prob, ref.R, ref.t, ref.points, HUBER)
    assert got.shape == () and float(got) == pytest.approx(want, abs=1e-12)
    assert 0.02 < want < 0.5
    assert float(ba.huber_share(SE3(ref.R, ref.t), ref.points, port,
                                None)) == 0.0
