"""Lie groups and small-matrix linear algebra: the PyTorch port against JAX
on random batches drawn with numpy, in float32 and in float64 (the test
suite runs JAX with x64 on, so every JAX input is cast to the working type
explicitly). Each comparison states its float32 bound; the float64 bound is
that bound scaled by the ratio of the two types' rounding units, eps64 /
eps32 = 1.9e-9, unless the test names another."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.math import lie as jl
from mvslam_tpu.math import linalg as jla
from mvslam_tpu_torch.math import lie as tl
from mvslam_tpu_torch.math import linalg as tla

#: float32 closed forms evaluated in different operation orders (XLA
#: fusion vs eager torch): a few ulp of the O(1) outputs
ATOL = 2e-5
#: eps64 / eps32: a float32 bound of a few ulp becomes the same few ulp
EPS_RATIO = float(np.finfo(np.float64).eps / np.finfo(np.float32).eps)


class Dt:
    """One working type on both sides."""

    def __init__(self, name):
        self.name = name
        self.np = np.dtype(name).type
        self.jnp = jnp.dtype(name)
        self.torch = getattr(torch, name)
        self.scale = 1.0 if name == "float32" else EPS_RATIO

    def draw(self, rng, *shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(self.np)

    def j(self, a):
        return jnp.asarray(a, self.jnp)

    def t(self, a):
        return torch.tensor(np.asarray(a), dtype=self.torch)

    def close(self, got, want, atol=ATOL, atol64=None):
        """``atol`` is the float32 bound; float64 takes ``atol64`` or the
        same number of rounding units."""
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == self.np         # the port kept the working type
        if self.name == "float64":
            atol = atol * EPS_RATIO if atol64 is None else atol64
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)

    def spd(self, rng, n, d):
        A = self.draw(rng, n, d, d)
        return (A @ np.swapaxes(A, -1, -2) + d * np.eye(d)).astype(self.np)


@pytest.fixture(params=["float32", "float64"])
def dt(request):
    return Dt(request.param)


@pytest.mark.parametrize("scale", [1e-5, 1e-2, 1.0])
def test_so3_exp_log(dt, scale):
    """Both sides of the Taylor switch and the trigonometric branch."""
    rng = np.random.default_rng(1)
    w = dt.draw(rng, 64, 3, scale=scale)
    dt.close(tl.so3_exp(dt.t(w)).numpy(), jl.so3_exp(dt.j(w)))
    R = np.asarray(jl.so3_exp(dt.j(w)), dt.np)
    dt.close(tl.so3_log(dt.t(R)).numpy(), jl.so3_log(dt.j(R)), atol=5e-5)


def test_skew_vee(dt):
    rng = np.random.default_rng(2)
    v = dt.draw(rng, 16, 3)
    np.testing.assert_array_equal(tl.skew(dt.t(v)).numpy(),
                                  np.asarray(jl.skew(dt.j(v))))
    M = dt.draw(rng, 16, 3, 3)
    dt.close(tl.vee(dt.t(M)).numpy(), jl.vee(dt.j(M)), atol=1e-6)


@pytest.mark.parametrize("op", ["exp", "log", "compose", "inverse", "apply"])
def test_se3_ops(dt, op):
    rng = np.random.default_rng(3)
    xi = dt.draw(rng, 32, 6)
    xi2 = dt.draw(rng, 32, 6)
    ja, jb = jl.SE3.exp(dt.j(xi)), jl.SE3.exp(dt.j(xi2))
    ta, tb = tl.SE3.exp(dt.t(xi)), tl.SE3.exp(dt.t(xi2))
    if op == "exp":
        dt.close(ta.R.numpy(), ja.R)
        dt.close(ta.t.numpy(), ja.t)
    elif op == "log":
        dt.close(ta.log().numpy(), ja.log(), atol=1e-4)
    elif op == "compose":
        dt.close(ta.compose(tb).R.numpy(), ja.compose(jb).R)
        dt.close(ta.compose(tb).t.numpy(), ja.compose(jb).t)
    elif op == "inverse":
        dt.close(ta.inverse().R.numpy(), ja.inverse().R)
        dt.close(ta.inverse().t.numpy(), ja.inverse().t)
    else:
        p = dt.draw(rng, 50, 3)
        one = tl.SE3(ta.R[0], ta.t[0])
        dt.close(one.apply(dt.t(p)).numpy(), jl.SE3(ja.R[0], ja.t[0]).apply(dt.j(p)))


def test_inv3x3_and_det3(dt):
    rng = np.random.default_rng(4)
    A = dt.spd(rng, 64, 3)
    dt.close(tla.inv3x3(dt.t(A)).numpy(), jla.inv3x3(dt.j(A)), atol=1e-5)
    np.testing.assert_allclose(tla.det3(dt.t(A)).numpy(),
                               np.asarray(jnp.linalg.det(dt.j(A))), rtol=1e-5)


def test_eigh3x3_full_and_smallest(dt):
    rng = np.random.default_rng(5)
    Hs = dt.spd(rng, 64, 3)
    lam_t, V_t = tla.eigh3x3_full(dt.t(Hs))
    lam_j, V_j = jla.eigh3x3_full(dt.j(Hs))
    dt.close(lam_t.numpy(), lam_j, atol=5e-5)
    # eigenvectors up to sign
    dots = np.abs(np.sum(V_t.numpy() * np.asarray(V_j), axis=-2))
    dt.close(dots, np.ones_like(dots), atol=1e-4)
    l_t, v_t = tla.eigh3x3_smallest(dt.t(Hs))
    l_j, v_j = jla.eigh3x3_smallest(dt.j(Hs))
    dt.close(l_t.numpy(), l_j, atol=5e-5)
    dt.close(np.abs(np.sum(v_t.numpy() * np.asarray(v_j), -1)), np.ones(64),
           atol=1e-4)


def test_svd3x3_matches(dt):
    rng = np.random.default_rng(6)
    M = dt.draw(rng, 64, 3, 3)
    U_t, s_t, Vt_t = tla.svd3x3(dt.t(M))
    U_j, s_j, Vt_j = jla.svd3x3(dt.j(M))
    dt.close(s_t.numpy(), s_j, atol=5e-5)
    recon = (U_t * s_t[..., None, :]) @ Vt_t
    dt.close(recon.numpy(), M, atol=1e-4)


@pytest.mark.parametrize("fn", ["project_to_so3", "polar_orthogonal"])
def test_rotation_projections(dt, fn):
    rng = np.random.default_rng(7)
    M = dt.draw(rng, 64, 3, 3)
    dt.close(getattr(tla, fn)(dt.t(M)).numpy(), getattr(jla, fn)(dt.j(M)),
           atol=1e-4)


@pytest.mark.parametrize("n", [4, 9, 12])
def test_smallest_eigvec_psd(dt, n):
    """Spectral amplification on DLT-like Gram matrices (one null
    direction plus noise), up to sign."""
    rng = np.random.default_rng(8 + n)
    A = dt.draw(rng, 32, 2 * n, n)
    A[:, :, -1] = A[:, :, :-1].sum(-1)          # one near-null direction
    A += dt.draw(rng, 32, 2 * n, n, scale=1e-3)
    M = np.swapaxes(A, -1, -2) @ A
    v_t = tla.smallest_eigvec_psd(dt.t(M)).numpy()
    v_j = np.asarray(jla.smallest_eigvec_psd(dt.j(M)))
    dt.close(np.abs(np.sum(v_t * v_j, -1)), np.ones(32), atol=1e-4)


def test_smallest_eigvecs2_psd_span(dt):
    """Two-vector variant on a 2-dim null space: same span."""
    rng = np.random.default_rng(9)
    A = dt.draw(rng, 32, 16, 9)
    A[:, :, 7] = A[:, :, 0] + A[:, :, 1]
    A[:, :, 8] = A[:, :, 2] - A[:, :, 3]
    M = np.swapaxes(A, -1, -2) @ A
    t1, t2 = (v.numpy() for v in tla.smallest_eigvecs2_psd(dt.t(M)))
    j1, j2 = (np.asarray(v) for v in jla.smallest_eigvecs2_psd(dt.j(M)))
    Pj = j1[..., :, None] * j1[..., None, :] + j2[..., :, None] * j2[..., None, :]
    Pt = t1[..., :, None] * t1[..., None, :] + t2[..., :, None] * t2[..., None, :]
    dt.close(Pt, Pj, atol=1e-3)


@pytest.mark.parametrize("fn", ["solve_psd", "inv_psd"])
def test_cholesky_solves(dt, fn):
    rng = np.random.default_rng(10)
    A = dt.spd(rng, 8, 6)
    b = dt.draw(rng, 8, 6)
    if fn == "solve_psd":
        got, want = tla.solve_psd(dt.t(A), dt.t(b)), jla.solve_psd(dt.j(A), dt.j(b))
    else:
        got, want = tla.inv_psd(dt.t(A)), jla.inv_psd(dt.j(A))
    dt.close(got.numpy(), want, atol=1e-5)


def test_solve_psd_non_pd_gives_nan_like_jax(dt):
    """A non-positive-definite system yields NaN (JAX's cholesky) instead
    of raising (torch.linalg.cholesky); the BA's jittered fallback relies
    on it."""
    A = -np.eye(6, dtype=dt.np)[None]
    b = np.ones((1, 6), dt.np)
    assert np.isnan(tla.solve_psd(dt.t(A), dt.t(b)).numpy()).all()
    assert np.isnan(np.asarray(jla.solve_psd(dt.j(A), dt.j(b)))).all()


def test_rpy_and_rectify(dt):
    rng = np.random.default_rng(12)
    r, p, y = (dt.draw(rng, 20, scale=0.6) for _ in range(3))
    want = jl.so3_from_rpy(dt.j(r), dt.j(p), dt.j(y))
    got = tl.so3_from_rpy(dt.t(r), dt.t(p), dt.t(y))
    dt.close(got.numpy(), want, atol=1e-6)
    for g, w in zip(tl.so3_rpy(got), jl.so3_rpy(want)):
        dt.close(g.numpy(), w, atol=1e-6)
    dt.close(tl.so3_rpy(got)[1].numpy(), p, atol=1e-6)   # the round trip
    # python floats with an explicit dtype, as the JAX package's tests call it
    one = tl.so3_from_rpy(0.1, -0.2, 0.3, dtype=dt.torch)
    dt.close(one.numpy(), jl.so3_from_rpy(0.1, -0.2, 0.3, dtype=dt.jnp),
             atol=1e-6)
    M = np.asarray(want, dt.np) + dt.draw(rng, 20, 3, 3, scale=0.01)
    dt.close(tl.so3_rectify(dt.t(M)).numpy(), jl.so3_rectify(dt.j(M)),
             atol=1e-6)
    R = tl.so3_rectify(dt.t(M))
    dt.close((R @ R.transpose(-1, -2)).numpy(),
             np.broadcast_to(np.eye(3, dtype=dt.np), (20, 3, 3)), atol=1e-6)
    assert tl.so3_adjoint(R) is R


def test_se3_adjoint(dt):
    rng = np.random.default_rng(15)
    xi, tw = dt.draw(rng, 8, 6, scale=0.5), dt.draw(rng, 8, 6, scale=0.1)
    T, J = tl.SE3.exp(dt.t(xi)), jl.SE3.exp(dt.j(xi))
    dt.close(T.adjoint().numpy(), J.adjoint(), atol=1e-6)
    assert T.batch_shape == J.batch_shape == (8,)
    # T exp(tw) T^-1 = exp(Ad tw)
    lhs = T.compose(tl.SE3.exp(dt.t(tw))).compose(T.inverse())
    rhs = tl.SE3.exp((T.adjoint() @ dt.t(tw)[..., None])[..., 0])
    dt.close(lhs.t.numpy(), rhs.t.numpy(), atol=1e-5)
    dt.close(lhs.R.numpy(), rhs.R.numpy(), atol=1e-5)


def test_se3_distance(dt):
    rng = np.random.default_rng(13)
    a, b = dt.draw(rng, 16, 6, scale=0.5), dt.draw(rng, 16, 6, scale=0.5)
    got = tl.se3_distance(tl.SE3.exp(dt.t(a)), tl.SE3.exp(dt.t(b)))
    want = jl.se3_distance(jl.SE3.exp(dt.j(a)), jl.SE3.exp(dt.j(b)))
    dt.close(got.numpy(), want, atol=1e-4)
    dt.close(got.numpy(), np.abs(a - b).max(-1), atol=1e-4)


def test_homogeneous_solve_and_so3_svd(dt):
    rng = np.random.default_rng(14)
    A = dt.draw(rng, 8, 12, 5)
    got = tla.homogeneous_solve(dt.t(A)).numpy()
    want = np.asarray(jla.homogeneous_solve(dt.j(A)))
    sign = np.sign(np.sum(got * want, -1, keepdims=True))
    # power iterations on a 5x5 spectrum: the float32 bound of
    # test_smallest_eigvec_psd
    dt.close(sign * got, want, atol=2e-3, atol64=1e-7)
    M = dt.draw(rng, 8, 3, 3)
    dt.close(tla.project_to_so3_svd(dt.t(M)).numpy(),
             jla.project_to_so3_svd(dt.j(M)), atol=1e-5)
    # the oracle of the iterative projection
    dt.close(tla.project_to_so3_svd(dt.t(M)).numpy(),
             tla.project_to_so3(dt.t(M)).numpy(), atol=1e-4, atol64=1e-9)


def test_config_constants_and_shapes():
    from mvslam_tpu import config as jc
    from mvslam_tpu_torch import config as tc

    for tname, jname in ((torch.float32, jnp.float32),
                         (torch.float64, jnp.float64)):
        for fn in ("epsilon", "tolerance", "taylor_threshold", "infinity"):
            assert getattr(tc, fn)(tname) == getattr(jc, fn)(jname), fn
    import dataclasses

    assert dataclasses.asdict(tc.StaticShapes()) == dataclasses.asdict(
        jc.StaticShapes())
    assert tc.DEFAULT_SHAPES == tc.StaticShapes()
    with pytest.raises(dataclasses.FrozenInstanceError):
        tc.DEFAULT_SHAPES.max_features = 1
