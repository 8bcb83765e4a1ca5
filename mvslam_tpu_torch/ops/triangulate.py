"""Batched two-view DLT triangulation with cheirality checks (port of
``mvslam_tpu.ops.triangulate``)."""

from __future__ import annotations

import torch

from mvslam_tpu_torch.math import linalg

Tensor = torch.Tensor


def triangulate_dlt(P1: Tensor, P2: Tensor, r1: Tensor, r2: Tensor) -> Tensor:
    """DLT triangulation of ray pairs: P1, P2 (..., 3, 4) ideal-camera
    projections, r1, r2 (..., N, 3) homogeneous image points -> (..., N, 3).
    Points at infinity are clamped rather than NaN'd."""
    def rows(P, x, y):
        P0 = P[..., None, 0, :]
        P1_ = P[..., None, 1, :]
        P2_ = P[..., None, 2, :]
        return x[..., None] * P2_ - P0, y[..., None] * P2_ - P1_

    a0, a1 = rows(P1, r1[..., 0], r1[..., 1])
    a2, a3 = rows(P2, r2[..., 0], r2[..., 1])
    A = torch.stack(torch.broadcast_tensors(a0, a1, a2, a3), dim=-2)
    X_h = linalg.smallest_eigvec_psd(A.transpose(-1, -2) @ A)
    w = X_h[..., 3]
    safe_w = torch.where(torch.abs(w) < torch.finfo(A.dtype).tiny ** 0.5,
                         torch.ones_like(w), w)
    return X_h[..., :3] / safe_w[..., None]


def point_depth(P: Tensor, X: Tensor) -> Tensor:
    """Camera-frame z of world points under ``P = [R | t]``: (..., N)."""
    return (torch.sum(P[..., None, 2, :3] * X, dim=-1) + P[..., None, 2, 3])


def cheirality_mask(P1: Tensor, P2: Tensor, X: Tensor,
                    min_depth: float = 0.0) -> Tensor:
    """Points in front of both cameras."""
    return (point_depth(P1, X) > min_depth) & (point_depth(P2, X) > min_depth)
