"""Camera intrinsics calibration from planar targets (Zhang's method; port of
``mvslam_tpu.ops.calibration``).

Our own rebuild of the numerical half of the reference's calibrate-camera
app (``utility/calibrate-camera.cpp:77-215``, which delegates to
``cv::calibrateCamera``): per-view homographies (our DLT), the absolute-
conic linear system for K, per-view extrinsics, and a joint Gauss-Newton
refinement of intrinsics + extrinsics over all reprojections. Radial lens
distortion (k1, k2) is estimated jointly when asked
(``estimate_distortion=True``); the saved camera model stays a pure
pinhole, so the distortion lives in the calibration result and the
:func:`undistort_points` / :func:`undistort_image` ops, not in
:class:`~mvslam_tpu_torch.ops.camera.PinholeCamera`.

Everything runs on the inputs' device. The Gauss-Newton loop is a Python
loop of a fixed count whose accept test is a ``torch.where``: no value is
read on the host inside it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvslam_tpu_torch.math import linalg
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops.homography import find_homography

Tensor = torch.Tensor


class CalibrationResult(NamedTuple):
    K: Tensor                  # (3, 3) intrinsics
    extrinsics: SE3            # (V,) world->camera per view
    rms_error: Tensor          # pixels
    per_view_error: Tensor     # (V,)
    dist: Tensor | None = None  # (2,) radial (k1, k2); None if not estimated


def _vij(H: Tensor, i: int, j: int) -> Tensor:
    """Zhang's constraint vector v_ij from homography columns, batched."""
    h_i = H[..., :, i]
    h_j = H[..., :, j]
    return torch.stack(
        [
            h_i[..., 0] * h_j[..., 0],
            h_i[..., 0] * h_j[..., 1] + h_i[..., 1] * h_j[..., 0],
            h_i[..., 1] * h_j[..., 1],
            h_i[..., 2] * h_j[..., 0] + h_i[..., 0] * h_j[..., 2],
            h_i[..., 2] * h_j[..., 1] + h_i[..., 1] * h_j[..., 2],
            h_i[..., 2] * h_j[..., 2],
        ],
        dim=-1,
    )


def _intrinsics_from_homographies(Hs: Tensor) -> Tensor:
    """K from >= 3 view homographies via the image of the absolute conic."""
    v12 = _vij(Hs, 0, 1)                       # (V, 6)
    v11 = _vij(Hs, 0, 0)
    v22 = _vij(Hs, 1, 1)
    Vmat = torch.cat([v12, v11 - v22], dim=0)  # (2V, 6)
    # Pixel-scale homographies make this system wildly ill-scaled (entries
    # span ~1..1e6, so cond(V^T V) ~ 1e24): equalize row norms, then use the
    # exact eigh null-space extractor (the amplification solver cannot
    # resolve a 1e-8 relative spectral gap). The eigenvector's sign does not
    # reach K: every entry below is even in b.
    row_norm = torch.linalg.vector_norm(Vmat, dim=-1, keepdim=True)
    Vmat = Vmat / torch.clamp(row_norm, min=torch.finfo(Hs.dtype).tiny)
    b = linalg.smallest_eigvec_psd_exact(Vmat.T @ Vmat)      # (6,)
    B11, B12, B22, B13, B23, B33 = b.unbind(-1)
    v0 = (B12 * B13 - B11 * B23) / (B11 * B22 - B12 * B12)
    lam = B33 - (B13 * B13 + v0 * (B12 * B13 - B11 * B23)) / B11
    alpha = torch.sqrt(torch.abs(lam / B11))
    beta = torch.sqrt(torch.abs(lam * B11 / (B11 * B22 - B12 * B12)))
    gamma = -B12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - B13 * alpha * alpha / lam
    zero, one = torch.zeros_like(alpha), torch.ones_like(alpha)
    return torch.stack([torch.stack([alpha, gamma, u0]),
                        torch.stack([zero, beta, v0]),
                        torch.stack([zero, zero, one])])


def _extrinsics_from_homography(K: Tensor, H: Tensor) -> SE3:
    """World (Z=0 plane) -> camera pose from K^-1 H, batched over views."""
    # the unchecked solve: ``torch.linalg.solve`` reads its error flag on
    # the host
    A = torch.linalg.solve_ex(K, H).result              # (..., 3, 3)
    lam = 1.0 / torch.linalg.vector_norm(A[..., :, 0], dim=-1)
    r1 = A[..., :, 0] * lam[..., None]
    r2 = A[..., :, 1] * lam[..., None]
    t = A[..., :, 2] * lam[..., None]
    r3 = torch.linalg.cross(r1, r2)
    # flip if the plane ended up behind the camera
    flip = torch.where(t[..., 2] < 0, -torch.ones_like(lam),
                       torch.ones_like(lam))
    R = torch.stack([r1 * flip[..., None], r2 * flip[..., None], r3], dim=-1)
    t = t * flip[..., None]
    # project to the closest rotation
    return SE3(linalg.project_to_so3(R), t)


def distort_normalized(xy: Tensor, dist: Tensor) -> Tensor:
    """Apply radial distortion ``x' = x (1 + k1 r^2 + k2 r^4)`` to ideal
    (normalized) image coordinates ``xy (..., 2)``; ``dist = (k1, k2)``."""
    r2 = torch.sum(xy * xy, dim=-1, keepdim=True)
    # one-element slices, not 0-dim entries: under ``torch.func.jacfwd`` a
    # 0-dim float32 tangent leaves Python-scalar arithmetic as float64
    return xy * (1.0 + dist[0:1] * r2 + dist[1:2] * r2 * r2)


def _project(K: Tensor, poses: SE3, X: Tensor,
             dist: Tensor | None = None) -> Tensor:
    """Project shared (N, 3) board points through (V,) world->camera poses
    (with optional radial distortion applied in normalized coordinates)."""
    Xc = torch.einsum("vij,nj->vni", poses.R, X) + poses.t[:, None, :]
    z = Xc[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    xy = Xc[..., :2] / z[..., None]
    if dist is not None:
        xy = distort_normalized(xy, dist)
    return torch.einsum("ij,vnj->vni", K[:2, :2], xy) + K[:2, 2][None, None, :]


def _pixel_frame(K: Tensor, dtype):
    """(fx, fy), (cx, cy) in ``dtype`` and the shear of ``K``."""
    fxy = torch.stack([K[0, 0], K[1, 1]]).to(dtype)
    cxy = torch.stack([K[0, 2], K[1, 2]]).to(dtype)
    return fxy, cxy, K[0, 1]


def undistort_points(pts: Tensor, K: Tensor, dist: Tensor,
                     iterations: int = 8) -> Tensor:
    """Distorted pixels ``(..., 2)`` -> undistorted pixels under the same K.

    Inverts the radial model by fixed-point iteration in normalized
    coordinates: ``x_{n+1} = x_d / (1 + k1 r_n^2 + k2 r_n^4)`` — the
    standard inversion (converges for |k r^2| < 1, i.e. any physically
    sane lens over its own field of view); the reference's
    ``cv::undistort`` half of ``calibrate-camera.cpp:208``.
    """
    fxy, cxy, shear = _pixel_frame(K, pts.dtype)
    # pixel -> normalized (invert [[fx, s], [0, fy]])
    yn = (pts[..., 1] - cxy[1]) / fxy[1]
    xn = (pts[..., 0] - cxy[0] - shear * yn) / fxy[0]
    xd = torch.stack([xn, yn], dim=-1)
    xu = xd
    for _ in range(iterations):
        r2 = torch.sum(xu * xu, dim=-1, keepdim=True)
        xu = xd / (1.0 + dist[0] * r2 + dist[1] * r2 * r2)
    u = fxy[0] * xu[..., 0] + shear * xu[..., 1] + cxy[0]
    v = fxy[1] * xu[..., 1] + cxy[1]
    return torch.stack([u, v], dim=-1)


def undistort_image(img: Tensor, K: Tensor, dist: Tensor) -> Tensor:
    """Resample a distorted ``(H, W)`` image onto the undistorted grid
    (bilinear; out-of-image samples clamp to the border — the preview the
    reference shows after calibration, ``calibrate-camera.cpp:199-213``).

    For each UNDISTORTED output pixel we distort its ray to find where the
    lens imaged it (the forward model — no iteration needed here).
    """
    dtype, dev = img.dtype, img.device
    H, W = img.shape
    yy, xx = torch.meshgrid(torch.arange(H, dtype=dtype, device=dev),
                            torch.arange(W, dtype=dtype, device=dev),
                            indexing="ij")
    fxy, cxy, shear = _pixel_frame(K, dtype)
    yn = (yy - cxy[1]) / fxy[1]
    xn = (xx - cxy[0] - shear * yn) / fxy[0]
    xyd = distort_normalized(torch.stack([xn, yn], dim=-1), dist)
    u = fxy[0] * xyd[..., 0] + shear * xyd[..., 1] + cxy[0]
    v = fxy[1] * xyd[..., 1] + cxy[1]
    # the sample clamps to 0..W-1, its base index to 0..W-2 (so the
    # right-hand neighbour exists; the last column is reached with du = 1)
    u = torch.clamp(u, 0.0, W - 1.0)
    v = torch.clamp(v, 0.0, H - 1.0)
    u0 = torch.clamp(torch.floor(u), 0, W - 2).to(torch.int64)
    v0 = torch.clamp(torch.floor(v), 0, H - 2).to(torch.int64)
    du = (u - u0).to(dtype)
    dv = (v - v0).to(dtype)
    p00 = img[v0, u0]
    p01 = img[v0, u0 + 1]
    p10 = img[v0 + 1, u0]
    p11 = img[v0 + 1, u0 + 1]
    return ((1 - dv) * ((1 - du) * p00 + du * p01)
            + dv * ((1 - du) * p10 + du * p11))


def calibrate_planar(
    board_points: Tensor,
    image_points: Tensor,
    weights: Tensor,
    refine_iterations: int = 10,
    estimate_distortion: bool = False,
) -> CalibrationResult:
    """Full calibration from V views of a planar target.

    board_points: (N, 2) target-plane coordinates (Z = 0) shared by views;
    image_points: (V, N, 2) detected pixels; weights: (V, N) validity.
    ``estimate_distortion=True`` additionally estimates radial (k1, k2)
    jointly with intrinsics/extrinsics; the homography/conic
    initialization stays distortion-free — standard Zhang: distortion
    starts at 0 and is resolved by the joint refine.
    """
    dtype, dev = image_points.dtype, image_points.device
    V, N = image_points.shape[:2]
    bp = board_points.expand(V, N, 2)
    Hs = find_homography(bp, image_points, weights)          # (V, 3, 3)
    K0 = _intrinsics_from_homographies(Hs)
    poses0 = _extrinsics_from_homography(K0, Hs)
    X = torch.cat([board_points, torch.zeros((N, 1), dtype=dtype, device=dev)],
                  dim=-1)
    n_dist = 2 if estimate_distortion else 0
    zero = torch.zeros((1,), dtype=dtype, device=dev)
    one = torch.ones((1,), dtype=dtype, device=dev)

    # joint GN over [fx, fy, shear, u0, v0] (+ [k1, k2]) + V * 6 extrinsics
    def unpack(theta):
        # ``torch.stack`` of slices, not ``torch.tensor`` of entries: that
        # would cut the tangent under ``jacfwd``
        K = torch.cat([theta[0:1], theta[2:3], theta[3:4],
                       zero, theta[1:2], theta[4:5],
                       zero, zero, one]).reshape(3, 3)
        dist = theta[5:5 + n_dist] if estimate_distortion else None
        xi = theta[5 + n_dist:].reshape(V, 6)
        poses = poses0.compose(SE3.exp(xi))
        return K, dist, poses

    def residuals(theta):
        K, dist, poses = unpack(theta)
        # poses here are world->camera: project X through pose directly
        proj = _project(K, poses, X, dist)
        r = (proj - image_points) * weights[..., None]
        return r.reshape(-1)

    theta0 = torch.cat([
        torch.stack([K0[0, 0], K0[1, 1], K0[0, 1], K0[0, 2], K0[1, 2]]),
        torch.zeros((n_dist + V * 6,), dtype=dtype, device=dev)])
    jacobian = torch.func.jacfwd(residuals)
    eye = torch.eye(theta0.shape[0], dtype=dtype, device=dev)

    theta = theta0
    for _ in range(refine_iterations):
        r = residuals(theta)
        J = jacobian(theta)
        H = J.T @ J
        g = -J.T @ r
        jitter = 1e-8 * (1.0 + torch.amax(torch.abs(H)))
        delta = torch.linalg.solve_ex(H + jitter * eye, g).result
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        new = theta + delta
        better = torch.sum(residuals(new) ** 2) < torch.sum(r ** 2)
        theta = torch.where(better, new, theta)
    K, dist, poses = unpack(theta)
    r = residuals(theta).reshape(V, N, 2)
    n_obs = torch.clamp(torch.sum(weights), min=1.0)
    rms = torch.sqrt(torch.sum(r ** 2) / n_obs)
    per_view = torch.sqrt(torch.sum(r ** 2, dim=(1, 2))
                          / torch.clamp(torch.sum(weights, 1), min=1.0))
    return CalibrationResult(K=K, extrinsics=poses, rms_error=rms,
                             per_view_error=per_view, dist=dist)
