"""Lie groups and small-matrix linear algebra: the PyTorch port against JAX
on random float32 batches drawn with numpy (the session runs JAX with x64
on, so every JAX input is cast to float32 explicitly)."""

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


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _t(a):
    return torch.tensor(a, dtype=torch.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _rotations(rng, n):
    return np.asarray(jl.so3_exp(_j(_f32(rng, n, 3))), np.float32)


def _spd(rng, n, d):
    A = _f32(rng, n, d, d)
    return (A @ np.swapaxes(A, -1, -2) + d * np.eye(d)).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-5, 1e-2, 1.0])
def test_so3_exp_log(scale):
    """Both sides of the Taylor switch and the trigonometric branch."""
    rng = np.random.default_rng(1)
    w = _f32(rng, 64, 3, scale=scale)
    _close(tl.so3_exp(_t(w)).numpy(), jl.so3_exp(_j(w)))
    R = np.asarray(jl.so3_exp(_j(w)), np.float32)
    _close(tl.so3_log(_t(R)).numpy(), jl.so3_log(_j(R)), atol=5e-5)


def test_skew_vee():
    rng = np.random.default_rng(2)
    v = _f32(rng, 16, 3)
    np.testing.assert_array_equal(tl.skew(_t(v)).numpy(),
                                  np.asarray(jl.skew(_j(v))))
    M = _f32(rng, 16, 3, 3)
    _close(tl.vee(_t(M)).numpy(), jl.vee(_j(M)), atol=1e-6)


@pytest.mark.parametrize("op", ["exp", "log", "compose", "inverse", "apply"])
def test_se3_ops(op):
    rng = np.random.default_rng(3)
    xi = _f32(rng, 32, 6)
    xi2 = _f32(rng, 32, 6)
    ja, jb = jl.SE3.exp(_j(xi)), jl.SE3.exp(_j(xi2))
    ta, tb = tl.SE3.exp(_t(xi)), tl.SE3.exp(_t(xi2))
    if op == "exp":
        _close(ta.R.numpy(), ja.R)
        _close(ta.t.numpy(), ja.t)
    elif op == "log":
        _close(ta.log().numpy(), ja.log(), atol=1e-4)
    elif op == "compose":
        _close(ta.compose(tb).R.numpy(), ja.compose(jb).R)
        _close(ta.compose(tb).t.numpy(), ja.compose(jb).t)
    elif op == "inverse":
        _close(ta.inverse().R.numpy(), ja.inverse().R)
        _close(ta.inverse().t.numpy(), ja.inverse().t)
    else:
        p = _f32(rng, 50, 3)
        one = tl.SE3(ta.R[0], ta.t[0])
        _close(one.apply(_t(p)).numpy(), jl.SE3(ja.R[0], ja.t[0]).apply(_j(p)))


def test_inv3x3_and_det3():
    rng = np.random.default_rng(4)
    A = _spd(rng, 64, 3)
    _close(tla.inv3x3(_t(A)).numpy(), jla.inv3x3(_j(A)), atol=1e-5)
    np.testing.assert_allclose(tla.det3(_t(A)).numpy(),
                               np.asarray(jnp.linalg.det(_j(A))), rtol=1e-5)


def test_eigh3x3_full_and_smallest():
    rng = np.random.default_rng(5)
    Hs = _spd(rng, 64, 3)
    lam_t, V_t = tla.eigh3x3_full(_t(Hs))
    lam_j, V_j = jla.eigh3x3_full(_j(Hs))
    _close(lam_t.numpy(), lam_j, atol=5e-5)
    # eigenvectors up to sign
    dots = np.abs(np.sum(V_t.numpy() * np.asarray(V_j), axis=-2))
    _close(dots, np.ones_like(dots), atol=1e-4)
    l_t, v_t = tla.eigh3x3_smallest(_t(Hs))
    l_j, v_j = jla.eigh3x3_smallest(_j(Hs))
    _close(l_t.numpy(), l_j, atol=5e-5)
    _close(np.abs(np.sum(v_t.numpy() * np.asarray(v_j), -1)), np.ones(64),
           atol=1e-4)


def test_svd3x3_matches():
    rng = np.random.default_rng(6)
    M = _f32(rng, 64, 3, 3)
    U_t, s_t, Vt_t = tla.svd3x3(_t(M))
    U_j, s_j, Vt_j = jla.svd3x3(_j(M))
    _close(s_t.numpy(), s_j, atol=5e-5)
    recon = (U_t * s_t[..., None, :]) @ Vt_t
    _close(recon.numpy(), M, atol=1e-4)


@pytest.mark.parametrize("fn", ["project_to_so3", "polar_orthogonal"])
def test_rotation_projections(fn):
    rng = np.random.default_rng(7)
    M = _f32(rng, 64, 3, 3)
    _close(getattr(tla, fn)(_t(M)).numpy(), getattr(jla, fn)(_j(M)),
           atol=1e-4)


@pytest.mark.parametrize("n", [4, 9, 12])
def test_smallest_eigvec_psd(n):
    """Spectral amplification on DLT-like Gram matrices (one null
    direction plus noise), up to sign."""
    rng = np.random.default_rng(8 + n)
    A = _f32(rng, 32, 2 * n, n)
    A[:, :, -1] = A[:, :, :-1].sum(-1)          # one near-null direction
    A += _f32(rng, 32, 2 * n, n, scale=1e-3)
    M = np.swapaxes(A, -1, -2) @ A
    v_t = tla.smallest_eigvec_psd(_t(M)).numpy()
    v_j = np.asarray(jla.smallest_eigvec_psd(_j(M)))
    _close(np.abs(np.sum(v_t * v_j, -1)), np.ones(32), atol=1e-4)


def test_smallest_eigvecs2_psd_span():
    """Two-vector variant on a 2-dim null space: same span."""
    rng = np.random.default_rng(9)
    A = _f32(rng, 32, 16, 9)
    A[:, :, 7] = A[:, :, 0] + A[:, :, 1]
    A[:, :, 8] = A[:, :, 2] - A[:, :, 3]
    M = np.swapaxes(A, -1, -2) @ A
    t1, t2 = (v.numpy() for v in tla.smallest_eigvecs2_psd(_t(M)))
    j1, j2 = (np.asarray(v) for v in jla.smallest_eigvecs2_psd(_j(M)))
    Pj = j1[..., :, None] * j1[..., None, :] + j2[..., :, None] * j2[..., None, :]
    Pt = t1[..., :, None] * t1[..., None, :] + t2[..., :, None] * t2[..., None, :]
    _close(Pt, Pj, atol=1e-3)


@pytest.mark.parametrize("fn", ["solve_psd", "inv_psd"])
def test_cholesky_solves(fn):
    rng = np.random.default_rng(10)
    A = _spd(rng, 8, 6)
    b = _f32(rng, 8, 6)
    if fn == "solve_psd":
        got, want = tla.solve_psd(_t(A), _t(b)), jla.solve_psd(_j(A), _j(b))
    else:
        got, want = tla.inv_psd(_t(A)), jla.inv_psd(_j(A))
    _close(got.numpy(), want, atol=1e-5)


def test_solve_psd_non_pd_gives_nan_like_jax():
    """A non-positive-definite system yields NaN (JAX's cholesky) instead
    of raising (torch.linalg.cholesky); the BA's jittered fallback relies
    on it."""
    A = -np.eye(6, dtype=np.float32)[None]
    b = np.ones((1, 6), np.float32)
    assert np.isnan(tla.solve_psd(_t(A), _t(b)).numpy()).all()
    assert np.isnan(np.asarray(jla.solve_psd(_j(A), _j(b)))).all()
