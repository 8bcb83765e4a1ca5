"""Planar homography estimation (DLT, Hartley-normalized, batched; port of
``mvslam_tpu.ops.homography``).

Support op for camera calibration (Zhang's method) and planar-scene
handling. The reference has no standalone homography op — its calibration
app delegates wholesale to ``cv::calibrateCamera``
(``utility/calibrate-camera.cpp:77-215``); here the solve is our own.
"""

from __future__ import annotations

import torch

from mvslam_tpu_torch.math import linalg
from mvslam_tpu_torch.ops.epipolar import (
    _apply_transform2d, normalization_transform,
)

Tensor = torch.Tensor


def find_homography(p_src: Tensor, p_dst: Tensor, weights: Tensor) -> Tensor:
    """H with ``p_dst ~ H p_src`` from (..., N, 2) point sets, batched.

    Hartley-normalizes both sets, solves the 2N x 9 DLT by smallest
    eigenvector of the normal matrix, denormalizes ``T_dst^-1 H' T_src``,
    and scales so ``H[2,2] = 1``.
    """
    T1 = normalization_transform(p_src, weights)
    T2 = normalization_transform(p_dst, weights)
    q1 = _apply_transform2d(T1, p_src)
    q2 = _apply_transform2d(T2, p_dst)
    x, y = q1[..., 0], q1[..., 1]
    u, v = q2[..., 0], q2[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    # rows for u: [-x, -y, -1, 0, 0, 0, u x, u y, u]
    row_u = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u],
                        dim=-1)
    row_v = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v],
                        dim=-1)
    A = torch.cat([row_u, row_v], dim=-2)
    w2 = torch.cat([weights, weights], dim=-1)
    A = A * w2[..., None]
    AtA = A.transpose(-1, -2) @ A
    h = linalg.smallest_eigvec_psd(AtA)
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    # the unchecked inverse: ``torch.linalg.inv`` reads its error flag on
    # the host
    H = torch.linalg.inv_ex(T2).inverse @ Hn @ T1
    scale = H[..., 2:3, 2:3]
    safe = torch.where(torch.abs(scale) < torch.finfo(H.dtype).tiny,
                       torch.ones_like(scale), scale)
    return H / safe


def homography_transfer_error_sq(H: Tensor, p_src: Tensor,
                                 p_dst: Tensor) -> Tensor:
    """Squared forward-transfer error per point, (..., N)."""
    ones = torch.ones_like(p_src[..., :1])
    ph = torch.cat([p_src, ones], dim=-1)
    q = torch.einsum("...ij,...nj->...ni", H, ph)
    w = q[..., 2]
    safe_w = torch.where(torch.abs(w) < torch.finfo(H.dtype).tiny,
                         torch.ones_like(w), w)
    proj = q[..., :2] / safe_w[..., None]
    return torch.sum((proj - p_dst) ** 2, dim=-1)
