"""The PyTorch port's homography and calibration ops against the JAX
package's, on the CPU: ``find_homography`` and its transfer error (batched),
``calibrate_planar`` on the two synthetic problems of the JAX package's own
calibration tests (with and without radial distortion), the undistortion
ops, the reference's bars asserted on the port, and the ``convert`` round
trip of a calibration result. Inputs are drawn with numpy; each comparison
states its tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.ops import calibration as jc
from mvslam_tpu.ops import homography as jh
from mvslam_tpu_torch import convert
from mvslam_tpu_torch.ops import calibration as tc
from mvslam_tpu_torch.ops import homography as th

K_TRUE = np.array([[420.0, 0.0, 310.0], [0.0, 415.0, 235.0], [0.0, 0.0, 1.0]])
DIST_TRUE = np.array([-0.25, 0.08])
DTYPES = {"float64": (torch.float64, jnp.float64),
          "float32": (torch.float32, jnp.float32)}
#: homographies and undistortion: relative to the largest entry (float32)
#: and absolute in pixels (float64)
RTOL32 = 1e-4
TOL64 = 1e-9
#: the float64 calibration of both packages, relative per quantity
CALIB_RTOL64 = 1e-6


def rpy(roll, pitch, yaw) -> np.ndarray:
    """``Rz(yaw) @ Ry(pitch) @ Rx(roll)`` (the packages' ``so3_from_rpy``)."""
    cr, sr, cp, sp = np.cos(roll), np.sin(roll), np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array([[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                     [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                     [-sp, cp * sr, cp * cr]])


def distort(xy, dist):
    r2 = np.sum(xy * xy, -1, keepdims=True)
    return xy * (1.0 + dist[0] * r2 + dist[1] * r2 * r2)


def problem(with_distortion: bool):
    """The synthetic problems of ``tests/test_apps_io.py``: 5 views of a
    6x9 board of 0.03 at 0.1 px noise; or 8 views of a centred board of
    0.1 through (k1, k2) = (-0.25, 0.08) at 0.05 px noise."""
    gx, gy = np.meshgrid(np.arange(9), np.arange(6))
    board = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float64)
    X = np.concatenate([board, np.zeros((54, 1))], -1)
    views = []
    if not with_distortion:
        board *= 0.03
        X[:, :2] = board
        rng = np.random.default_rng(1)
        for v in range(5):
            R = rpy(*rng.uniform(-0.3, 0.3, 3))
            t = np.array([0.05 * v - 0.1, 0.05, 0.6 + 0.1 * v])
            Xc = X @ R.T + t
            px = Xc[:, :2] / Xc[:, 2:3] @ K_TRUE[:2, :2].T + K_TRUE[:2, 2]
            views.append(px + rng.normal(0, 0.1, px.shape))
    else:
        board = board * 0.1
        board -= board.mean(0)
        X[:, :2] = board
        rng = np.random.default_rng(3)
        for v in range(8):
            R = rpy(*rng.uniform(-0.35, 0.35, 3))
            t = np.array([0.04 * v - 0.14, 0.03 * (v % 3) - 0.03,
                          0.8 + 0.08 * v])
            Xc = X @ R.T + t
            xy = distort(Xc[:, :2] / Xc[:, 2:3], DIST_TRUE)
            px = xy @ K_TRUE[:2, :2].T + K_TRUE[:2, 2]
            views.append(px + rng.normal(0, 0.05, px.shape))
    return board, np.stack(views)


def both(fn_j, fn_t, arrays, dtype):
    """Call the JAX function and the port's on the same numpy arrays."""
    tdt, jdt = DTYPES[dtype]
    return (fn_j(*(jnp.asarray(a, jdt) for a in arrays)),
            fn_t(*(torch.tensor(a, dtype=tdt) for a in arrays)))


def close(got, want, dtype):
    got = got.numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    if dtype == "float64":
        assert err <= TOL64, err
    else:
        assert err <= RTOL32 * max(np.abs(want).max(), 1.0), err


# ---------------------------------------------------------------------------
# homography
# ---------------------------------------------------------------------------


def _homography_batch(rng, batch=(3, 2), n=40):
    Hs = np.eye(3) + rng.normal(0, 0.05, batch + (3, 3))
    Hs[..., :2, 2] += rng.uniform(-20, 20, batch + (2,))
    Hs[..., 2, :2] = rng.normal(0, 1e-3, batch + (2,))
    src = rng.uniform(0, 300, batch + (n, 2))
    q = np.einsum("...ij,...nj->...ni", Hs,
                  np.concatenate([src, np.ones(batch + (n, 1))], -1))
    clean = q[..., :2] / q[..., 2:]
    dst = clean + rng.normal(0, 0.3, batch + (n, 2))
    w = (rng.uniform(size=batch + (n,)) > 0.1).astype(np.float64)
    return clean, src, dst, w


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_find_homography_batched(rng, dtype):
    clean, src, dst, w = _homography_batch(rng)
    jH, tH = both(jh.find_homography, th.find_homography, (src, dst, w), dtype)
    assert tH.shape == (3, 2, 3, 3) and tH.dtype == DTYPES[dtype][0]
    close(tH, jH, dtype)
    # and it maps the sources onto the noiseless targets (noise: 0.3 px)
    err = th.homography_transfer_error_sq(tH.double(), torch.tensor(src),
                                          torch.tensor(clean))
    assert float(err.mean().sqrt()) < 0.5


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_homography_transfer_error_batched(rng, dtype):
    _, src, dst, w = _homography_batch(rng)
    Hs = np.asarray(jh.find_homography(*(jnp.asarray(a) for a in (src, dst, w))))
    jE, tE = both(jh.homography_transfer_error_sq,
                  th.homography_transfer_error_sq, (Hs, src, dst), dtype)
    assert tE.shape == (3, 2, 40)
    close(tE, jE, dtype)


# ---------------------------------------------------------------------------
# calibrate_planar
# ---------------------------------------------------------------------------


def _calibrate(with_distortion: bool, dtype: str):
    board, views = problem(with_distortion)
    w = np.ones(views.shape[:2])
    kw = (dict(refine_iterations=60, estimate_distortion=True)
          if with_distortion else {})
    return both(lambda b, v, ww: jc.calibrate_planar(b, v, ww, **kw),
                lambda b, v, ww: tc.calibrate_planar(b, v, ww, **kw),
                (board, views, w), dtype)


@pytest.mark.parametrize("with_distortion", [False, True],
                         ids=["pinhole", "radial"])
def test_calibrate_planar_equals_jax_float64(with_distortion):
    jres, tres = _calibrate(with_distortion, "float64")
    want = convert.calibration_result_to_numpy(jres)
    got = convert.calibration_result_to_numpy(tres)
    assert got.keys() == want.keys()
    assert ("dist" in got) == with_distortion
    for k in want:
        assert got[k].dtype == np.float64, k
        scale = max(np.abs(want[k]).max(), 1.0)
        assert np.abs(got[k] - want[k]).max() <= CALIB_RTOL64 * scale, k


@pytest.mark.parametrize("with_distortion", [False, True],
                         ids=["pinhole", "radial"])
def test_calibrate_planar_reference_bars(with_distortion):
    """``tests/test_apps_io.py``'s bars, held on the port."""
    _, res = _calibrate(with_distortion, "float64")
    K = res.K.numpy()
    assert abs(K[0, 0] - 420.0) < 5.0, K
    assert abs(K[1, 1] - 415.0) < 5.0, K
    if with_distortion:
        k = res.dist.numpy()
        assert abs(k[0] + 0.25) < 0.02, k
        assert abs(k[1] - 0.08) < 0.05, k
    else:
        assert res.dist is None
        assert abs(K[0, 2] - 310.0) < 5.0, K
        assert abs(K[1, 2] - 235.0) < 5.0, K
    assert float(res.rms_error) < 0.3


@pytest.mark.parametrize("with_distortion", [False, True],
                         ids=["pinhole", "radial"])
def test_calibrate_planar_float32(with_distortion):
    """In float32 the Jacobian's tangents stay float32 and the solve keeps
    the reference's bars; against JAX in float32 within 1e-3 of K's scale
    (both end on a float32 floor of the Gauss-Newton)."""
    jres, tres = _calibrate(with_distortion, "float32")
    assert tres.K.dtype == torch.float32
    assert tres.rms_error.dtype == torch.float32
    K = tres.K.numpy()
    assert abs(K[0, 0] - 420.0) < 5.0 and abs(K[1, 1] - 415.0) < 5.0, K
    assert float(tres.rms_error) < 0.3
    np.testing.assert_allclose(K, np.asarray(jres.K), atol=1e-3 * 420.0)
    if with_distortion:
        np.testing.assert_allclose(tres.dist.numpy(), np.asarray(jres.dist),
                                   atol=1e-3)


# ---------------------------------------------------------------------------
# undistortion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_undistort_points(rng, dtype):
    pix = rng.uniform([40, 40], [580, 430], (64, 2))
    K = K_TRUE.copy()
    K[0, 1] = 0.7                                    # a shear, to cover it
    jU, tU = both(jc.undistort_points, tc.undistort_points,
                  (pix, K, DIST_TRUE), dtype)
    close(tU, jU, dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_undistort_points_inverts_the_model(rng, dtype):
    """The reference's bar: the forward model inverted to 1e-3 px."""
    tdt = DTYPES[dtype][0]
    pix = rng.uniform([40, 40], [580, 430], (64, 2))
    yn = (pix[:, 1] - K_TRUE[1, 2]) / K_TRUE[1, 1]
    xn = (pix[:, 0] - K_TRUE[0, 2]) / K_TRUE[0, 0]
    pix_d = (distort(np.stack([xn, yn], -1), DIST_TRUE) @ K_TRUE[:2, :2].T
             + K_TRUE[:2, 2])
    back = tc.undistort_points(torch.tensor(pix_d, dtype=tdt),
                               torch.tensor(K_TRUE, dtype=tdt),
                               torch.tensor(DIST_TRUE, dtype=tdt))
    assert float((back.double() - torch.tensor(pix)).abs().max()) < 1e-3


def _sample_columns(K, dist, w):
    """Where ``undistort_image`` samples the source along the top row."""
    xn = (np.arange(w) - K[0, 2]) / K[0, 0]
    yn = np.full(w, (0.0 - K[1, 2]) / K[1, 1])
    xyd = distort(np.stack([xn, yn], -1), dist)
    return K[0, 0] * xyd[:, 0] + K[0, 2]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["barrel", "pincushion"])
def test_undistort_image_with_borders(rng, dtype, sign):
    """The whole image, border pixels included, for a barrel lens and a
    pincushion one: K / 3 on a 120x160 image. Under the pincushion lens the
    top row's rays land outside the image on both sides, so both clamps
    (the sample to 0..W-1, the base index to 0..W-2) are taken."""
    img = rng.uniform(size=(120, 160))
    K = K_TRUE / 3.0
    K[2, 2] = 1.0
    dist = sign * DIST_TRUE
    jI, tI = both(jc.undistort_image, tc.undistort_image,
                  (img, K, dist), dtype)
    assert tI.shape == img.shape and bool(torch.isfinite(tI).all())
    close(tI, jI, dtype)
    u = _sample_columns(K, dist, 160)
    if sign < 0:
        assert u.min() < 0.0 and u.max() > 159.0, (u.min(), u.max())
        # clamped samples read the border columns exactly
        np.testing.assert_allclose(tI.numpy()[0, 0], img[0, 0], rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_distort_normalized(rng, dtype):
    xy = rng.normal(0, 0.4, (5, 7, 2))
    jD, tD = both(jc.distort_normalized, tc.distort_normalized,
                  (xy, DIST_TRUE), dtype)
    close(tD, jD, dtype)


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_distortion", [False, True],
                         ids=["pinhole", "radial"])
def test_calibration_result_round_trip(with_distortion):
    jres, tres = _calibrate(with_distortion, "float64")
    for res in (jres, tres):
        d = convert.calibration_result_to_numpy(res)
        back = convert.calibration_result_from_numpy(d, device="cpu")
        assert back.K.dtype == torch.float64
        assert (back.dist is None) == (not with_distortion)
        again = convert.calibration_result_to_numpy(back)
        assert again.keys() == d.keys()
        for k in d:
            np.testing.assert_array_equal(again[k], d[k], err_msg=k)
    f32 = convert.calibration_result_from_numpy(
        convert.calibration_result_to_numpy(jres), device="cpu",
        dtype=torch.float32)
    assert f32.K.dtype == f32.extrinsics.R.dtype == torch.float32
