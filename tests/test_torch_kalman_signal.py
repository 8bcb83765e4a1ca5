"""The port's Kalman filter, low-pass filter and state estimates: the cases
of ``tests/test_kalman.py`` and ``tests/test_signal.py`` rerun on torch,
and direct comparisons with the JAX package on inputs from a numpy seed
(float32 within 1e-5 relative, float64 within 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.math import kalman as jk
from mvslam_tpu.math import signal as jsig
from mvslam_tpu.math import state_estimate as jse
from mvslam_tpu.math.lie import SE3 as JSE3
from mvslam_tpu_torch.math import kalman as tk
from mvslam_tpu_torch.math import signal as tsig
from mvslam_tpu_torch.math import state_estimate as tse
from mvslam_tpu_torch.math.lie import SE3

DTYPES = [("float32", 1e-5), ("float64", 1e-10)]


def _pair(a, name):
    a = np.asarray(a)
    return (torch.tensor(a, dtype=getattr(torch, name)),
            jnp.asarray(a, getattr(jnp, name)))


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()))


# -- the JAX package's own cases, on torch ---------------------------------


def test_moving_mass_tracking(rng):
    f64 = torch.float64
    dt, v_true, steps, noise = 0.1, 0.7, 100, 1e-2
    F = torch.tensor([[1.0, dt], [0.0, 1.0]], dtype=f64)
    Q = torch.eye(2, dtype=f64) * 1e-6
    H = torch.tensor([[1.0, 0.0]], dtype=f64)
    R = torch.tensor([[noise ** 2]], dtype=f64)
    state = tk.kf_init(torch.zeros(2, dtype=f64), torch.eye(2, dtype=f64))
    pos = 0.0
    for _ in range(steps):
        pos += v_true * dt
        z = torch.tensor([pos + rng.normal(0, noise)], dtype=f64)
        state, ok = tk.kf_process_update(state, F, Q)
        assert bool(ok)
        state, ok = tk.kf_measurement_update(state, H, z, R)
        assert bool(ok)
    assert abs(float(state.x[0]) - pos) < 2e-2
    assert abs(float(state.x[1]) - v_true) < 2e-2


def test_control_input():
    f64 = torch.float64
    state = tk.kf_init(torch.zeros(2, dtype=f64), torch.eye(2, dtype=f64))
    state, ok = tk.kf_process_update(
        state, torch.eye(2, dtype=f64), torch.zeros((2, 2), dtype=f64),
        torch.tensor([[1.0], [0.0]], dtype=f64),
        torch.tensor([0.5], dtype=f64))
    assert bool(ok)
    np.testing.assert_allclose(state.x.numpy(), [0.5, 0.0])


def test_nonfinite_rollback():
    f64 = torch.float64
    state = tk.kf_init(torch.zeros(2, dtype=f64), torch.eye(2, dtype=f64))
    new, ok = tk.kf_process_update(
        state, torch.full((2, 2), float("nan"), dtype=f64),
        torch.zeros((2, 2), dtype=f64))
    assert not bool(ok)
    assert torch.equal(new.x, state.x) and torch.equal(new.P, state.P)
    # a singular innovation covariance rolls the measurement update back
    new, ok = tk.kf_measurement_update(
        state, torch.zeros((1, 2), dtype=f64), torch.ones(1, dtype=f64),
        torch.zeros((1, 1), dtype=f64))
    assert not bool(ok)
    assert torch.equal(new.x, state.x) and torch.equal(new.P, state.P)


def test_lpf_hand_computed():
    y = torch.tensor(0.0, dtype=torch.float64)
    for e in [0.5, 0.75, 0.875, 0.9375]:
        y = tsig.lpf_update(y, 1.0, 0.5)
        assert abs(float(y) - e) < 1e-12


def test_lpf_scan_matches_loop(rng):
    xs = rng.normal(size=50)
    ys = tsig.lpf_scan(torch.tensor(0.0, dtype=torch.float64),
                       torch.tensor(xs), 0.3)
    y = 0.0
    for i, x in enumerate(xs):
        y = y + 0.3 * (x - y)
        assert abs(float(ys[i]) - y) < 1e-12
    empty = tsig.lpf_scan(torch.zeros(3), torch.zeros((0, 3)), 0.3)
    assert empty.shape == (0, 3)


def test_utility():
    assert float(tsig.sqr(torch.tensor(3.0))) == 9.0
    for x, want in ((5.0, 1.0), (-5.0, 0.0), (0.5, 0.5)):
        assert float(tsig.constrain(torch.tensor(x), 0.0, 1.0)) == want


# -- against the JAX package ------------------------------------------------


@pytest.mark.parametrize("name,rtol", DTYPES)
def test_kalman_matches(rng, name, rtol):
    """Ten process (with control) + measurement updates of a 4-state
    filter with 2 measurements."""
    n, m = 4, 2
    A = rng.normal(size=(n, n))
    tx, jx = _pair(rng.normal(size=n), name)
    tP, jP = _pair(A @ A.T + np.eye(n), name)
    tF, jF = _pair(np.eye(n) + 0.1 * rng.normal(size=(n, n)), name)
    tQ, jQ = _pair(0.01 * np.eye(n), name)
    tB, jB = _pair(rng.normal(size=(n, 2)), name)
    tH, jH = _pair(rng.normal(size=(m, n)), name)
    tR, jR = _pair(0.1 * np.eye(m), name)
    ts, js = tk.kf_init(tx, tP), jk.kf_init(jx, jP)
    for _ in range(10):
        tu, ju = _pair(rng.normal(size=2), name)
        tz, jz = _pair(rng.normal(size=m), name)
        ts, tok = tk.kf_process_update(ts, tF, tQ, tB, tu)
        js, jok = jk.kf_process_update(js, jF, jQ, jB, ju)
        assert bool(tok) == bool(jok) is True
        ts, tok = tk.kf_measurement_update(ts, tH, tz, tR)
        js, jok = jk.kf_measurement_update(js, jH, jz, jR)
        assert bool(tok) == bool(jok) is True
        _close(ts.x, js.x, 10 * rtol)      # ten updates compound
        _close(ts.P, js.P, 10 * rtol)
    assert ts.x.dtype == getattr(torch, name)


@pytest.mark.parametrize("name,rtol", DTYPES)
def test_batched_filters(rng, name, rtol):
    """Leading batch axes take the place of ``vmap``: a bank of 16 filters
    against the JAX package's vmapped updates, and the rollback decided
    per filter."""
    import jax

    B = 16
    tF, jF = _pair(np.broadcast_to([[1.0, 0.1], [0.0, 1.0]], (B, 2, 2)), name)
    tQ, jQ = _pair(np.broadcast_to(np.eye(2) * 1e-6, (B, 2, 2)), name)
    tH, jH = _pair(np.broadcast_to([[1.0, 0.0]], (B, 1, 2)), name)
    tR, jR = _pair(np.broadcast_to([[1e-4]], (B, 1, 1)), name)
    tz, jz = _pair(rng.normal(size=(B, 1)), name)
    tx, jx = _pair(rng.normal(size=(B, 2)), name)
    tP, jP = _pair(np.broadcast_to(np.eye(2), (B, 2, 2)), name)
    ts, js = tk.KFState(tx, tP), jk.KFState(jx, jP)
    proc = jax.vmap(lambda s, f, q: jk.kf_process_update(s, f, q))
    meas = jax.vmap(lambda s, h, z, r: jk.kf_measurement_update(s, h, z, r))
    ts, tok = tk.kf_process_update(ts, tF, tQ)
    js, jok = proc(js, jF, jQ)
    assert tok.shape == (B,) and bool(tok.all()) and bool(jok.all())
    ts, tok = tk.kf_measurement_update(ts, tH, tz, tR)
    js, jok = meas(js, jH, jz, jR)
    assert ts.x.shape == (B, 2)
    _close(ts.x, js.x, rtol)
    _close(ts.P, js.P, rtol)
    # one filter of the bank goes non-finite: only that one rolls back
    bad = tF.clone()
    bad[5] = float("nan")
    jbad = jnp.asarray(bad.numpy())
    new, ok = tk.kf_process_update(ts, bad, tQ)
    jnew, jok = proc(js, jbad, jQ)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.tolist() == [k != 5 for k in range(B)]
    assert torch.equal(new.x[5], ts.x[5]) and torch.equal(new.P[5], ts.P[5])
    _close(new.x, jnew.x, rtol)


@pytest.mark.parametrize("name,rtol", DTYPES)
def test_lpf_matches(rng, name, rtol):
    tx, jx = _pair(rng.normal(size=(30, 3)), name)
    ty, jy = _pair(rng.normal(size=3), name)
    _close(tsig.lpf_scan(ty, tx, 0.2), jsig.lpf_scan(jy, jx, 0.2), rtol)
    _close(tsig.lpf_update(ty, tx[0], 0.2), jsig.lpf_update(jy, jx[0], 0.2),
           rtol)
    _close(tsig.constrain(tx, -0.5, 0.5), jsig.constrain(jx, -0.5, 0.5), 0)
    _close(tsig.sqr(tx), jsig.sqr(jx), rtol)


@pytest.mark.parametrize("name,rtol", DTYPES)
def test_state_estimates_match(rng, name, rtol):
    tm, jm = _pair(rng.normal(size=(5, 3)), name)
    A = rng.normal(size=(5, 3, 3))
    tc, jc = _pair(A @ A.transpose(0, 2, 1) + np.eye(3), name)
    _close(tse.point3_estimate(tm, tc).info(),
           jse.point3_estimate(jm, jc).info(), 10 * rtol)
    for stddev in (None, 0.5):
        got = tse.point3_estimate(tm, stddev=stddev)
        want = jse.point3_estimate(jm, stddev=stddev)
        assert got.covar.shape == (5, 3, 3) and got.covar.dtype == tm.dtype
        _close(got.covar, want.covar, rtol)
        _close(got.info(), want.info(), rtol)
        got2 = tse.point2_estimate(tm[:, :2], stddev=stddev)
        want2 = jse.point2_estimate(jm[:, :2], stddev=stddev)
        assert got2.covar.shape == (5, 2, 2)
        _close(got2.covar, want2.covar, rtol)
    xi = rng.normal(size=6) * 0.3
    B = rng.normal(size=(6, 6))
    tcov, jcov = _pair(B @ B.T + np.eye(6), name)
    txi, jxi = _pair(xi, name)
    got = tse.TransformationEstimate(SE3.exp(txi), tcov)
    want = jse.TransformationEstimate(JSE3.exp(jxi), jcov)
    _close(got.info(), want.info(), 10 * rtol)
    _close(got.mean.t, want.mean.t, rtol)


@pytest.mark.parametrize("name", ["float32", "float64"])
def test_info_of_a_singular_covariance_matches(name):
    """A singular covariance: ``info()`` returns what ``jnp.linalg.inv``
    does (nan, inf and the finite entries in the same places), not an
    error."""
    cov3 = np.diag([1.0, 0.0, 1.0])
    cov6 = np.diag([1.0, 0.0, 1.0, 1.0, 1.0, 1.0])
    tm, jm = _pair(np.zeros(3), name)
    tc3, jc3 = _pair(cov3, name)
    tc6, jc6 = _pair(cov6, name)
    pairs = [(tse.StateEstimate(tm, tc3).info(),
              jse.StateEstimate(jm, jc3).info()),
             (tse.TransformationEstimate(SE3.identity(), tc6).info(),
              jse.TransformationEstimate(JSE3.identity(), jc6).info())]
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert not np.isfinite(want).all()
        for pattern in (np.isnan, np.isposinf, np.isneginf, np.isfinite):
            np.testing.assert_array_equal(pattern(got), pattern(want))
        np.testing.assert_array_equal(got[np.isfinite(got)],
                                      want[np.isfinite(want)])
