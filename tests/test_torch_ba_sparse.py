"""The PyTorch port's sparse bundle adjustment against the JAX package's.

One 16-frame x 8-points-per-frame sequence problem, drawn with numpy from a
seed by the port's generator, goes through both packages as the same arrays
(``convert.problem_to_numpy``): residuals and Jacobians, the assembled
blocks, the matrix-free Schur product, the PCG and the whole LM solve, in
float32 and float64. Then, port only: sparse == dense on ``densify()``, and
the generators' contracts.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.math.lie import SE3 as JSE3
from mvslam_tpu.ops import ba_sparse as jbs
from mvslam_tpu_torch import convert
from mvslam_tpu_torch.ops import ba as tba
from mvslam_tpu_torch.ops import ba_sparse as tbs
from mvslam_tpu_torch.parallel.synthetic import (
    make_sequence_ba_problem, make_window_ba_problem,
)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64)}
#: agreement of one evaluation (residuals, blocks, products), relative to the
#: largest magnitude of the compared array: rounding of the dtype times the
#: length of the reductions
EVAL_RTOL = {"float32": 2e-5, "float64": 1e-12}
#: agreement of the whole LM solve: relative on the cost; on poses and points
#: relative to the trajectory's span (7.5 units). The chain is anchored at
#: frame 0 only, so its global scale is a weak mode that float32 rounding
#: moves by ~5e-5 of the span (measured 3.5e-4 absolute at the far end)
SOLVE_TOL = {"float32": 1e-4, "float64": 1e-9}


def _jax_problem(d: dict) -> jbs.SparseBAProblem:
    def se3(name):
        return JSE3(jnp.asarray(d[f"{name}.R"]), jnp.asarray(d[f"{name}.t"]))

    return jbs.SparseBAProblem(
        se3("poses0"), jnp.asarray(d["points0"]),
        jnp.asarray(d["obs_frame"], jnp.int32), jnp.asarray(d["obs"]),
        jnp.asarray(d["obs_mask"]), jnp.asarray(d["obs_weight"]),
        se3("pose_prior"), jnp.asarray(d["pose_prior_info"]),
        jnp.asarray(d["point_prior"]), jnp.asarray(d["point_prior_info"]))


@pytest.fixture(scope="module", params=list(DTYPES))
def problems(request):
    tdt, _ = DTYPES[request.param]
    tprob, _, _ = make_sequence_ba_problem(
        7, num_frames=16, points_per_frame=8, window=4, dtype=tdt,
        device="cpu")
    d = convert.problem_to_numpy(tprob)
    assert d["points0"].dtype == np.dtype(request.param)
    return request.param, tprob, _jax_problem(d)


def _close(got, want, rtol, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def test_problem_round_trips_through_numpy(problems):
    _, tprob, _ = problems
    back = convert.sparse_ba_problem_from_numpy(
        convert.problem_to_numpy(tprob), device="cpu")
    for a, b in zip(convert.problem_to_numpy(tprob).values(),
                    convert.problem_to_numpy(back).values()):
        np.testing.assert_array_equal(a, b)
    assert back.obs_frame.dtype == torch.int64
    assert back.obs_mask.dtype == torch.bool


def test_residuals_and_jacobians_match(problems):
    name, tp, jp = problems
    got = tbs._residuals(tp.poses0, tp.points0, tp)
    want = jbs._residuals(jp.poses0, jp.points0, jp)
    for g, w, what in zip(got, want, ("r", "Jc", "Jp")):
        _close(g, w, EVAL_RTOL[name], what)


def test_cost_matches(problems):
    name, tp, jp = problems
    got = float(tbs._cost(tp.poses0, tp.points0, tp))
    want = float(jbs._cost(jp.poses0, jp.points0, jp))
    assert abs(got - want) <= EVAL_RTOL[name] * abs(want)


def test_assembled_blocks_match(problems):
    name, tp, jp = problems
    got = tbs._assemble(tp.poses0, tp.points0, tp, 1e-4)
    want = jbs._assemble(jp.poses0, jp.points0, jp, 1e-4)
    for field in ("Hcc", "A", "bc", "bp"):
        _close(getattr(got, field), getattr(want, field), EVAL_RTOL[name],
               field)
    # the inverse of a landmark block amplifies rounding by its conditioning
    # (depth is the weak direction of a 4-frame track)
    _close(got.Hpp_inv, want.Hpp_inv, 100 * EVAL_RTOL[name], "Hpp_inv")
    np.testing.assert_array_equal(got.seg.numpy(), np.asarray(want.seg))


def test_schur_matvec_and_pcg_match(problems):
    name, tp, jp = problems
    F = tp.num_frames
    x = np.random.default_rng(3).standard_normal((F, 6)).astype(name)
    tasm = tbs._assemble(tp.poses0, tp.points0, tp, 1e-4)
    jasm = jbs._assemble(jp.poses0, jp.points0, jp, 1e-4)
    _close(tbs._schur_matvec(tasm, torch.from_numpy(x), F),
           jbs._schur_matvec(jasm, jnp.asarray(x), F), EVAL_RTOL[name])
    params = dict(cg_iterations=12)
    got = tbs._pcg(tasm, tasm.bc, F, tbs.SparseBAParams(**params))
    want = jbs._pcg(jasm, jasm.bc, F, jbs.SparseBAParams(**params))
    # 12 CG steps amplify rounding by the system's conditioning
    _close(got, want, 50 * EVAL_RTOL[name], "pcg")


def test_solve_matches(problems):
    name, tp, jp = problems
    params = dict(max_iterations=12, cg_iterations=30)
    got = tbs.sparse_ba_solve(tp, tbs.SparseBAParams(**params))
    want = jbs.sparse_ba_solve(jp, jbs.SparseBAParams(**params))
    tol = SOLVE_TOL[name]
    span = float(np.ptp(np.asarray(want.poses.t)[:, 0]))
    assert float(got.error) < 0.1 * float(tbs._cost(tp.poses0, tp.points0, tp))
    assert abs(float(got.error) - float(want.error)) <= tol * (
        1.0 + float(want.error))
    np.testing.assert_allclose(got.poses.t.numpy(), np.asarray(want.poses.t),
                               rtol=0, atol=tol * span)
    np.testing.assert_allclose(got.poses.R.numpy(), np.asarray(want.poses.R),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                               rtol=0, atol=10 * tol * span)
    if name == "float64":
        assert int(got.iterations) == int(want.iterations)
        assert bool(got.converged) == bool(want.converged)


def test_densify_matches(problems):
    _, tp, jp = problems
    got, want = tbs.densify(tp), jbs.densify(jp)
    np.testing.assert_array_equal(got.obs_mask.numpy(),
                                  np.asarray(want.obs_mask))
    np.testing.assert_array_equal(got.obs.numpy(), np.asarray(want.obs))
    np.testing.assert_array_equal(got.obs_weight.numpy(),
                                  np.asarray(want.obs_weight))


def test_sparse_lands_on_the_dense_optimum():
    """As ``tests/test_ba_sparse.py`` holds the JAX solver: the inexact-PCG
    LM reaches the optimum of the dense Cholesky LM (float64)."""
    prob, _, _ = make_sequence_ba_problem(
        0, num_frames=8, points_per_frame=24, window=4, dtype=torch.float64,
        device="cpu")
    dense = tba.ba_solve(
        tbs.densify(prob),
        tba.BAParams(max_iterations=40, compute_covariance=False))
    sparse = tbs.sparse_ba_solve(
        prob, tbs.SparseBAParams(max_iterations=40, cg_iterations=60))
    np.testing.assert_allclose(sparse.poses.t.numpy(), dense.poses.t.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(sparse.points.numpy(), dense.points.numpy(),
                               atol=1e-5)
    assert abs(float(sparse.error) - float(dense.error)) < 1e-4 * (
        1.0 + float(dense.error))


def test_sequence_problem_layout_and_seed():
    a, poses_true, pts_true = make_sequence_ba_problem(
        5, num_frames=6, points_per_frame=4, window=3, device="cpu")
    b, _, _ = make_sequence_ba_problem(
        5, num_frames=6, points_per_frame=4, window=3, device="cpu")
    c, _, _ = make_sequence_ba_problem(
        6, num_frames=6, points_per_frame=4, window=3, device="cpu")
    assert a.obs_frame.shape == (24, 3) and a.points0.shape == (24, 3)
    assert poses_true.t.shape == (6, 3) and pts_true.shape == (24, 3)
    # landmarks ordered by anchor keyframe; clipped duplicates masked out
    assert torch.equal(a.obs_frame[:, 0], torch.arange(6).repeat_interleave(4))
    assert not bool(a.obs_mask[-1, 1:].any())
    assert torch.equal(a.obs, b.obs) and not torch.equal(a.obs, c.obs)
    # frame 0 is the anchor: unperturbed, with the tight prior
    assert torch.equal(a.poses0.t[0], poses_true.t[0])
    assert float(a.pose_prior_info[0, 0, 0]) == pytest.approx(1e10, rel=1e-6)
    assert float(a.pose_prior_info[1:].abs().max()) == 0.0


def test_window_problem_is_solved_by_the_dense_ba():
    prob, poses_true, _ = make_window_ba_problem(
        2, num_frames=4, num_points=64, dtype=torch.float64, device="cpu")
    assert prob.obs.shape == (4, 64, 2)
    c0 = float(tba._cost(prob.poses0, prob.points0, prob))
    res = tba.ba_solve(prob, tba.BAParams(max_iterations=20,
                                          compute_covariance=False))
    assert float(res.error) < 0.05 * c0
    assert float((res.poses.t - poses_true.t).abs().max()) < 0.02


@pytest.mark.parametrize("make", [make_sequence_ba_problem,
                                  make_window_ba_problem],
                         ids=lambda f: f.__name__)
def test_generators_default_to_the_card(make):
    assert inspect.signature(make).parameters["device"].default == "cuda"
