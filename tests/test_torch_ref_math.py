"""The JAX package's own math bars, rerun on the port: ``tests/test_lie.py``,
``tests/test_linalg.py``, the state-estimate cases of ``tests/test_utils.py``
and the ``ParameterManager`` cases of ``tests/test_config.py``, on
``mvslam_tpu_torch.math.{lie,linalg,state_estimate}`` and
``mvslam_tpu_torch.config``.

Each case builds the reference's inputs from the same numpy seed, holds the
port to the reference's own bar in float64 and float32 (where the reference
runs both), and compares the port with the JAX function on the same inputs
within that bar. (a) rerun here; (b) an existing test already asserts the
bar; (c) not applicable.

| reference case | | where |
|---|---|---|
| `test_lie.py::test_skew_cross_product` | a | `test_skew_cross_product` |
| `test_lie.py::test_so3_exp_log_roundtrip` | a | `test_so3_exp_log_roundtrip` |
| `test_lie.py::test_so3_orthonormal` | a | `test_so3_orthonormal` |
| `test_lie.py::test_so3_rectify` | b | `test_torch_math.py::test_rpy_and_rectify` (R R^T = I within 1e-6 after rectify) |
| `test_lie.py::test_rpy_roundtrip` | a | `test_rpy_roundtrip` |
| `test_lie.py::test_se3_exp_log_roundtrip` | a | `test_se3_exp_log_roundtrip` |
| `test_lie.py::test_se3_exp_small_angle` | a | `test_se3_exp_small_angle` |
| `test_lie.py::test_se3_compose_inverse` | a | `test_se3_compose_inverse` (needed `SE3.__matmul__`) |
| `test_lie.py::test_se3_matrix_roundtrip` | a | `test_se3_matrix_roundtrip` |
| `test_lie.py::test_se3_inverse_formula` | a | `test_se3_inverse_formula` |
| `test_lie.py::test_se3_distance` | a | `test_se3_distance` |
| `test_lie.py::test_batched_shapes` | a | `test_batched_shapes` |
| `test_lie.py::test_se3_adjoint_defining_property` | b | `test_torch_math.py::test_se3_adjoint` (T exp(xi) T^-1 = exp(Ad xi) within the bar) |
| `test_lie.py::test_so3_adjoint_is_rotation` | a | `test_so3_adjoint_is_rotation` |
| `test_linalg.py::test_homogeneous_nullspace` | a | `test_homogeneous_nullspace` |
| `test_linalg.py::test_smallest_eigvec` | a | `test_smallest_eigvec` |
| `test_linalg.py::test_project_to_so3` | a | `test_project_to_so3` |
| `test_linalg.py::test_solve_inv_psd` | a | `test_solve_inv_psd` |
| `test_linalg.py::test_inv3x3` | a | `test_inv3x3` |
| `test_linalg.py::test_smallest_eigvec_inverse_iteration_matches_eigh` | a | `test_smallest_eigvec_inverse_iteration_matches_eigh` |
| `test_linalg.py::test_project_to_so3_newton_matches_svd` | a | `test_project_to_so3_newton_matches_svd` |
| `test_utils.py::test_state_estimate_info_is_inverse_covar` | a | `test_state_estimate_info_is_inverse_covar` |
| `test_utils.py::test_point_estimates_isotropic` | a | `test_point_estimates_isotropic` |
| `test_utils.py::test_transformation_estimate` | a | `test_transformation_estimate` |
| `test_utils.py` string cases (3) | b | `test_torch_leaf_utils.py` (the same cases on `utils.strings`) |
| `test_config.py::test_save_load_roundtrip` | a | `test_save_load_roundtrip` |
| `test_config.py::test_defaults_and_types` | a | `test_defaults_and_types` |
| `test_config.py::test_ini_format` | a | `test_ini_format` |
| `test_config.py::test_numeric_constants` | b | `test_torch_math.py::test_config_constants_and_shapes` (every constant equal to JAX's) |

The state-estimate and config cases have no ``dtype`` fixture in the
reference; they run as it does (float64, and no tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu import config as jconfig
from mvslam_tpu.math import lie as jl
from mvslam_tpu.math import linalg as jla
from mvslam_tpu.math import state_estimate as jse
from mvslam_tpu_torch import config as tconfig
from mvslam_tpu_torch.math import fma as tfma
from mvslam_tpu_torch.math import lie as tl
from mvslam_tpu_torch.math import linalg as tla
from mvslam_tpu_torch.math import state_estimate as tse

import chip_smoke as cs
from test_torch_ref_common import DTYPES, Dt, check_similar_se3, random_se3
from test_torch_ref_common import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(params=DTYPES)
def dt(request):
    return Dt(request.param)


def _tol(dt):
    """``test_lie.py::_tol``."""
    return 1e-9 if dt.f64 else 2e-5


@jax.jit
def _jax_se3_roundtrip(xi):
    return jl.SE3.exp(xi).log()


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


# -- tests/test_lie.py ------------------------------------------------------


def test_skew_cross_product(rng, dt):
    a, b = rng.normal(size=(17, 3)), rng.normal(size=(17, 3))
    ta, tb = dt.t(a), dt.t(b)
    got = torch.einsum("nij,nj->ni", tl.skew(ta), tb)
    _close(got, torch.linalg.cross(ta, tb), _tol(dt))
    _close(tl.vee(tl.skew(ta)), ta, _tol(dt))
    _close(got, jnp.einsum("nij,nj->ni", jl.skew(dt.j(a)), dt.j(b)), _tol(dt))


def test_so3_exp_log_roundtrip(rng, dt):
    mags = np.array([1e-9, 1e-7, 1e-5, 1e-3, 0.1, 1.0, 2.0, 3.0])
    axes = rng.normal(size=(len(mags), 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    w = axes * mags[:, None]
    atol = 1e-7 if dt.f64 else 2e-3
    w2 = tl.so3_log(tl.so3_exp(dt.t(w)))
    _close(w2, w.astype(dt.np), atol)
    _close(w2, jax.jit(lambda v: jl.so3_log(jl.so3_exp(v)))(dt.j(w)), atol)


def test_so3_orthonormal(rng, dt):
    w = rng.normal(size=(32, 3))
    R = tl.so3_exp(dt.t(w))
    _close(R @ R.transpose(-1, -2), np.broadcast_to(np.eye(3), (32, 3, 3)),
           100 * _tol(dt))
    _close(torch.linalg.det(R), np.ones(32), 100 * _tol(dt))
    _close(R, jl.so3_exp(dt.j(w)), _tol(dt))


def test_rpy_roundtrip(dt):
    roll, pitch, yaw = 0.3, -0.4, 1.2
    R = tl.so3_from_rpy(roll, pitch, yaw, dtype=dt.torch)
    atol = 1e-9 if dt.f64 else 1e-5
    for got, want in zip(tl.so3_rpy(R), (roll, pitch, yaw)):
        assert got.dtype == dt.torch
        _close(float(got), want, atol)
    _close(R, jl.so3_from_rpy(roll, pitch, yaw, dtype=dt.jnp), atol)


def test_se3_exp_log_roundtrip(rng, dt):
    xi = np.concatenate(
        [rng.normal(size=(64, 3)), rng.uniform(-1, 1, size=(64, 3)) * 0.9],
        axis=-1)
    atol = 1e-7 if dt.f64 else 1e-4
    xi2 = tl.SE3.exp(dt.t(xi)).log()
    _close(xi2, xi.astype(dt.np), atol)
    _close(xi2, _jax_se3_roundtrip(dt.j(xi)), atol)


def test_se3_exp_small_angle(dt):
    xi = np.array([[0.5, -0.2, 0.1, 1e-8, -1e-8, 1e-9]])
    T = tl.SE3.exp(dt.t(xi))
    _close(T.t[0], [0.5, -0.2, 0.1], 1e-6)
    _close(T.log()[0], dt.t(xi)[0], 1e-6)
    _close(T.log(), _jax_se3_roundtrip(dt.j(xi)), 1e-6)


def test_se3_compose_inverse(rng, dt):
    T1 = random_se3(rng, 1.0, dt)
    T2 = random_se3(rng, 1.0, dt)
    T = T1 @ T2
    ident = T @ T.inverse()
    assert check_similar_se3(ident, tl.SE3.identity(dtype=dt.torch), 1e-5)
    p = rng.normal(size=(10, 3))
    atol = 1e-9 if dt.f64 else 1e-5
    _close(T.apply(dt.t(p)), T1.apply(T2.apply(dt.t(p))), atol)
    J = jl.SE3(dt.j(T1.R), dt.j(T1.t)) @ jl.SE3(dt.j(T2.R), dt.j(T2.t))
    _close(T.apply(dt.t(p)), J.apply(dt.j(p)), atol)


def test_se3_matrix_roundtrip(rng, dt):
    T = random_se3(rng, 1.0, dt)
    M = T.matrix()
    assert check_similar_se3(T, tl.SE3.from_matrix(M), 1e-6)
    assert M.shape == (4, 4) and M.dtype == dt.torch
    _close(M[3], [0, 0, 0, 1], 0)
    _close(M, jl.SE3(dt.j(T.R), dt.j(T.t)).matrix(), 0)


def test_se3_inverse_formula(rng, dt):
    T = random_se3(rng, 0.7, dt)
    atol = 1e-9 if dt.f64 else 1e-5
    _close(T.inverse().t, -(T.R.T @ T.t), atol)
    _close(T.inverse().t, jl.SE3(dt.j(T.R), dt.j(T.t)).inverse().t, atol)


def test_se3_distance(rng, dt):
    T = random_se3(rng, 0.5, dt)
    assert float(tl.se3_distance(T, T)) < 1e-6
    T2 = random_se3(rng, 0.5, dt)
    d = float(tl.se3_distance(T, T2))
    assert d > 1e-3
    want = jl.se3_distance(jl.SE3(dt.j(T.R), dt.j(T.t)),
                           jl.SE3(dt.j(T2.R), dt.j(T2.t)))
    _close(d, want, 1e-6)


@pytest.mark.parametrize("n", [1, 5])
def test_batched_shapes(rng, n, dt):
    xi = rng.normal(size=(n, 4, 6))
    T = tl.SE3.exp(dt.t(xi))
    assert T.R.shape == (n, 4, 3, 3)
    assert T.t.shape == (n, 4, 3)
    assert T.log().shape == (n, 4, 6)
    assert T.matrix().shape == (n, 4, 4, 4)
    assert T.matrix().dtype == dt.torch


def test_so3_adjoint_is_rotation(rng, dt):
    w = rng.normal(size=3) * 0.4
    R = tl.so3_exp(dt.t(w))
    v = rng.normal(size=3)
    lhs = R @ tl.so3_exp(dt.t(v)) @ R.T
    rhs = tl.so3_exp(tl.so3_adjoint(R) @ dt.t(v))
    atol = 1e-9 if dt.f64 else 1e-5
    _close(lhs, rhs, atol)
    jR = jl.so3_exp(dt.j(w))
    _close(rhs, jl.so3_exp(jl.so3_adjoint(jR) @ dt.j(v)), atol)


# -- tests/test_linalg.py ---------------------------------------------------


def test_homogeneous_nullspace(rng, dt):
    x_true = rng.normal(size=5)
    x_true /= np.linalg.norm(x_true)
    A = rng.normal(size=(8, 5))
    A = A - np.outer(A @ x_true, x_true)
    x = tla.homogeneous_solve(dt.t(A)).numpy()
    bar = 1 - 1e-9 if dt.f64 else 1 - 1e-4
    assert abs(float(np.dot(x, x_true))) > bar
    assert abs(float(np.dot(x, np.asarray(jla.homogeneous_solve(dt.j(A)))))) \
        > bar


def test_smallest_eigvec(rng, dt):
    Q = np.linalg.qr(rng.normal(size=(6, 6)))[0]
    lams = np.array([1e-6, 1.0, 2.0, 3.0, 4.0, 5.0])
    M = Q @ np.diag(lams) @ Q.T
    v = tla.smallest_eigvec_psd(dt.t(M)).numpy()
    assert abs(float(np.dot(v, Q[:, 0]))) > 1 - 1e-4
    vj = np.asarray(jax.jit(jla.smallest_eigvec_psd)(dt.j(M)))
    assert abs(float(np.dot(v, vj))) > 1 - 1e-4


def test_project_to_so3(rng, dt):
    R_true = tl.so3_exp(torch.tensor(rng.normal(size=(7, 3)))).numpy()
    noisy = R_true * rng.uniform(0.5, 2.0)
    R = tla.project_to_so3(dt.t(noisy)).numpy()
    atol = 1e-7 if dt.f64 else 1e-4
    _close(R, R_true, atol)
    _close(np.linalg.det(R.astype(np.float64)), np.ones(7), 1e-5)
    _close(R, jax.jit(jla.project_to_so3)(dt.j(noisy)), atol)


def test_solve_inv_psd(rng, dt):
    A = rng.normal(size=(4, 9, 9))
    A = A @ np.swapaxes(A, -1, -2) + 9 * np.eye(9)
    b = rng.normal(size=(4, 9))
    atol = 1e-8 if dt.f64 else 1e-3
    x = tla.solve_psd(dt.t(A), dt.t(b)).numpy()
    _close(np.einsum("nij,nj->ni", A, x), b, atol)
    Ainv = tla.inv_psd(dt.t(A)).numpy()
    _close(A @ Ainv, np.broadcast_to(np.eye(9), A.shape), atol)
    jx = np.asarray(jla.solve_psd(dt.j(A), dt.j(b)))
    _close(np.einsum("nij,nj->ni", A, x - jx), np.zeros_like(b), atol)


def test_inv3x3(rng, dt):
    A = rng.normal(size=(32, 3, 3)) + 3 * np.eye(3)
    atol = 1e-9 if dt.f64 else 1e-3
    Ainv = tla.inv3x3(dt.t(A)).numpy()
    _close(A @ Ainv, np.broadcast_to(np.eye(3), A.shape), atol)
    _close(A @ (Ainv - np.asarray(jla.inv3x3(dt.j(A)))),
           np.zeros(A.shape), atol)


def test_smallest_eigvec_inverse_iteration_matches_eigh(rng, dt):
    bar = 1 - 1e-9 if dt.f64 else 1 - 1e-4
    for n in (3, 4, 9, 12):
        A = rng.normal(size=(64, 2 * n, n))
        u, _, vt = np.linalg.svd(A, full_matrices=False)
        s = rng.uniform(1.0, 4.0, size=(64, n))
        s[:, -1] = rng.uniform(0, 1e-5, size=64)
        A = u @ (s[..., None] * vt)
        M = np.swapaxes(A, -1, -2) @ A
        v_fast = tla.smallest_eigvec_psd(dt.t(M)).numpy()
        v_ref = tla.smallest_eigvec_psd_exact(dt.t(M)).numpy()
        dots = np.abs(np.sum(v_fast * v_ref, axis=-1))
        assert dots.min() > bar, (n, dots.min())
        v_jax = np.asarray(jax.jit(jla.smallest_eigvec_psd)(dt.j(M)))
        dots = np.abs(np.sum(v_fast * v_jax, axis=-1))
        assert dots.min() > bar, (n, dots.min())


def test_project_to_so3_newton_matches_svd(rng, dt):
    M = rng.normal(size=(128, 3, 3))
    M[:32] = np.linalg.qr(M[:32])[0] + 0.01 * rng.normal(size=(32, 3, 3))
    M[32:48] *= 5.0
    M[48:64] = -M[48:64]
    tol = 1e-7 if dt.f64 else 2e-3
    R_fast = tla.project_to_so3(dt.t(M)).numpy().astype(np.float64)
    R_ref = tla.project_to_so3_svd(dt.t(M)).numpy().astype(np.float64)
    _close(np.linalg.det(R_fast), np.ones(128), 10 * tol)
    _close(R_fast @ np.swapaxes(R_fast, -1, -2),
           np.broadcast_to(np.eye(3), R_fast.shape), 10 * tol)
    d_fast = np.linalg.norm(R_fast - M, axis=(-2, -1))
    d_ref = np.linalg.norm(R_ref - M, axis=(-2, -1))
    _close(d_fast, d_ref, 20 * tol)
    R_jax = np.asarray(jax.jit(jla.project_to_so3)(dt.j(M)), np.float64)
    _close(d_fast, np.linalg.norm(R_jax - M, axis=(-2, -1)), 20 * tol)


# -- tests/test_utils.py: state estimates (float64, as the reference) --------

F64 = torch.float64


def test_state_estimate_info_is_inverse_covar():
    covar = np.diag([4.0, 9.0, 16.0])
    est = tse.StateEstimate(torch.zeros(3, dtype=F64),
                            torch.tensor(covar, dtype=F64))
    want = np.diag([0.25, 1 / 9, 1 / 16])
    _close(est.info(), want, 1e-12)
    _close(est.info(), jse.StateEstimate(jnp.zeros(3), jnp.asarray(covar))
           .info(), 1e-12)


def test_point_estimates_isotropic():
    p3 = tse.point3_estimate(torch.zeros((5, 3), dtype=F64), stddev=0.5)
    assert p3.covar.shape == (5, 3, 3) and p3.covar.dtype == F64
    _close(p3.covar[0], 0.25 * np.eye(3), 0)
    p2 = tse.point2_estimate(torch.zeros((7, 2), dtype=F64), stddev=2.0)
    _close(p2.covar[3], 4.0 * np.eye(2), 0)
    _close(p2.covar, jse.point2_estimate(jnp.zeros((7, 2)), stddev=2.0).covar,
           0)


def test_transformation_estimate():
    est = tse.TransformationEstimate(tl.SE3.identity(dtype=F64),
                                     1e-4 * torch.eye(6, dtype=F64))
    np.testing.assert_allclose(est.info().numpy(), 1e4 * np.eye(6),
                               rtol=1e-6)
    want = jse.TransformationEstimate(jl.SE3.identity(),
                                      1e-4 * jnp.eye(6)).info()
    np.testing.assert_allclose(est.info().numpy(), np.asarray(want),
                               rtol=1e-12)


# -- tests/test_config.py: ParameterManager ----------------------------------


def _both():
    return tconfig.ParameterManager(), jconfig.ParameterManager()


def test_save_load_roundtrip(tmp_path):
    pm = tconfig.ParameterManager()
    pm.set_value("VisualOdometer", "frame_queue_size", 10)
    pm.set_value("VisualOdometer", "max_error", 0.5)
    pm.set_value("ImagePair", "refine_structure_in_constructor", "false")
    path = str(tmp_path / "system.param")
    assert pm.save_to_file(path) == 3

    # the JAX package reads what the port wrote
    for pm2 in _both():
        assert pm2.load_from_file(path) == 3
        assert pm2.module_count() == 2
        assert pm2.get_value("VisualOdometer", "frame_queue_size", 0) == 10
        assert pm2.get_value("VisualOdometer", "max_error", 0.0) == 0.5
        assert pm2.get_value("ImagePair", "refine_structure_in_constructor",
                             True) is False


def test_defaults_and_types():
    for pm in _both():
        assert pm.get_value("NoModule", "nothing", 42) == 42
        assert pm.get_value("NoModule", "nothing", 0.5) == 0.5
        pm.DEBUG_set_module_parameters("M", {"a": "1.5", "b": "TRUE",
                                             "c": "-3"})
        assert pm.get_value("M", "a", 0.0) == 1.5
        assert pm.get_value("M", "b", False) is True
        assert pm.get_value("M", "c", 0) == -3
        pm.DEBUG_set_module_parameters("M", {"d": "0.1", "e": "0"})
        assert pm.get_value("M", "d", False) is True
        assert pm.get_value("M", "e", True) is False


def test_ini_format(tmp_path):
    path = tmp_path / "p.param"
    path.write_text("[Mod]\nkey = value with spaces\nnum = 7\n\n[Other]\n"
                    "x = 1\n")
    for pm in _both():
        assert pm.load_from_file(str(path)) == 3
        assert pm.get_value("Mod", "key", "") == "value with spaces"
        assert pm.get_value("Mod", "num", 0) == 7
        assert pm.get_value("Other", "x", 0) == 1


# -- the DLT null-space solver's float32 arithmetic -------------------------
#
# The minimal 8-point DLTs of a two-plane scene are near-degenerate: over
# the batch below, the median eigenvalues of A^T A over its trace are
# -9.7e-12, 3.6e-8 and 1.4e-6 (float64 eigh of the float32 Gram matrix),
# all at or under float32's 1.2e-7. Which bottom pair the spectral
# amplification returns is then set by the last bits of its sums, and
# float32 cannot resolve that subspace: JAX's own float32
# ``smallest_eigvecs2_psd`` spans float64 eigh's bottom pair within 0.35
# degrees at the median and 87 degrees at worst (its
# ``smallest_eigvec_psd``: 70.6 degrees at the median); the port's pair
# 0.31 and 78 degrees. The 8-point solve used to take those sums from the
# host's BLAS (MKL sums small products as a fused multiply-add chain on
# AVX-512 Intel hosts, with a multiply and an add in other orders on its
# AVX2 and compatibility paths), so its bootstraps agreed with JAX's on one
# host and not on another. On the CPU it now forms its Gram matrices and
# squarings as that chain (``math/fma.py``: XLA's summation, bit for bit)
# and its shift's trace and read-out in MKL's AVX-512 orders: the pair the
# port computed on AVX-512 Intel hosts, now on every BLAS path. Where
# float32 can resolve the subspace (``test_dlt_solver_spans_eigh_subspace``)
# both packages are held to float64 eigh.

#: the median angle between the pair and float64 eigh's bottom pair on the
#: two-plane batch, in both packages (radians; measured 5.4e-3 in the port,
#: 6.0e-3 in JAX)
DLT_MEDIAN_ANGLE = 1e-2


@pytest.fixture(scope="module")
def dlt_batch():
    A = cs.two_plane_dlt()
    M = cs.dlt_gram(A)
    j1, j2 = jax.jit(jla.smallest_eigvecs2_psd)(jnp.asarray(M.numpy()))
    return A, M, {"two": np.stack([np.asarray(j1), np.asarray(j2)], -1)}


def test_fma_matmul_is_the_jax_dot(dlt_batch):
    """The amplification's squarings come out of the port bit for bit as
    out of XLA's dot; the batch is near-degenerate."""
    _, M, _ = dlt_batch
    lam = np.linalg.eigvalsh(M.double().numpy())
    ratio = lam / np.trace(M.double().numpy(), axis1=-2, axis2=-1)[:, None]
    assert np.median(np.abs(ratio[:, 0])) < 1e-9
    assert np.median(ratio[:, 2]) < 1e-5
    B = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (256, 9, 9)).astype(np.float32))
    np.testing.assert_array_equal(
        tfma.fma_matmul(B, B).numpy(),
        np.asarray(jax.jit(lambda b: b @ b)(B.numpy())))
    # one rounding per step: (1 + u)(1 - u) - 1 is -u^2, not the 0 of a
    # rounded product (u = 2^-23)
    a = torch.tensor([[[1.0, 1.0 + 2.0 ** -23]]])
    b = torch.tensor([[[-1.0], [1.0 - 2.0 ** -23]]])
    assert float(tfma.fma_matmul(a, b)) == -2.0 ** -46


def test_dlt_solver_matches_jax_on_a_near_degenerate_batch(dlt_batch):
    """On the near-degenerate batch the pair is resolved as well as JAX's
    float32 pair is: the same median angle to float64 eigh's bottom pair
    (the worst hypotheses are rounding's in both, see above)."""
    _, M, jax_out = dlt_batch
    ref = np.linalg.eigh(M.double().numpy())[1][..., :2]
    port = np.median(cs.span_angle(cs.solve_spans(M)["two"], ref))
    jax_ = np.median(cs.span_angle(jax_out["two"], ref))
    assert port < DLT_MEDIAN_ANGLE and jax_ < DLT_MEDIAN_ANGLE, (port, jax_)


@pytest.mark.parametrize("env", ["MKL_CBWR=COMPATIBLE",
                                 "MKL_ENABLE_INSTRUCTIONS=AVX2"])
def test_dlt_solver_is_the_same_on_other_blas_paths(dlt_batch, tmp_path,
                                                    env):
    """MKL picks its kernels once per process: a subprocess on another of
    its code paths (the ones other hosts take) gives the same Gram matrices,
    amplified matrices and pairs, bit for bit."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    A, M, _ = dlt_batch
    np.save(tmp_path / "M.npy", M.numpy())
    code = (
        "import sys, numpy as np, torch\n"
        "from mvslam_tpu_torch.math import fma, linalg as tla\n"
        "M = torch.from_numpy(np.load(sys.argv[1]))\n"
        "A = torch.from_numpy(np.load(sys.argv[3]))\n"
        "v1, v2 = tla.smallest_eigvecs2_psd(M)\n"
        "np.savez(sys.argv[2], two=torch.stack([v1, v2], -1).numpy(),\n"
        "         B=tla._amplify(M, 24, fused=True).numpy(),\n"
        "         gram=fma.fma_matmul(A.mT, A).numpy())\n")
    np.save(tmp_path / "A.npy", A)
    key, value = env.split("=")
    repo = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "M.npy"),
         str(tmp_path / "out.npz"), str(tmp_path / "A.npy")],
        cwd=repo, env=dict(os.environ, **{key: value, "PYTHONPATH": str(repo)}),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = np.load(tmp_path / "out.npz")
    np.testing.assert_array_equal(out["gram"], M.numpy())
    np.testing.assert_array_equal(out["B"],
                                  tla._amplify(M, 24, fused=True).numpy())
    np.testing.assert_array_equal(out["two"], cs.solve_spans(M)["two"])


@pytest.mark.parametrize("which", ["two", "one"])
def test_dlt_solver_spans_eigh_subspace(which):
    """Where float32 resolves the bottom subspace, the solver spans float64
    eigh's: a PSD batch with eigenvalues (0, 1e-10, 1e-3, ...) of its scale
    for the pair, (0, 0.05, ...) for the one vector (24 squarings separate
    a ratio of 1e-3, 12 one of 0.05), rounded to float32. The bound is the
    float32 rounding of the matrix over the gap (measured 1.5e-4 and 2.1e-6
    radians); JAX's float32 result meets it too."""
    M32 = cs.separated_psd(which)
    k = 2 if which == "two" else 1
    ref = np.linalg.eigh(M32.astype(np.float64))[1][..., :k]
    got = cs.solve_spans(torch.from_numpy(M32))[which]
    bound = cs.SOLVER_EIGH_ANGLE[which]
    assert cs.span_angle(got, ref).max() < bound
    if which == "two":
        j1, j2 = jax.jit(jla.smallest_eigvecs2_psd)(M32)
        jx = np.stack([np.asarray(j1), np.asarray(j2)], -1)
    else:
        jx = np.asarray(jax.jit(jla.smallest_eigvec_psd)(M32))[..., None]
    assert cs.span_angle(jx, ref).max() < bound
