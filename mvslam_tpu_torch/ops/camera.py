"""Pinhole camera model (port of ``mvslam_tpu.ops.camera``): intrinsics
``K`` and world->camera extrinsics ``P``, batched project/normalize."""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvslam_tpu_torch.math.lie import SE3

Tensor = torch.Tensor


class PinholeCamera(NamedTuple):
    """Camera = intrinsics (3, 3) + world->camera SE3."""

    K: Tensor
    P: SE3

    @staticmethod
    def from_params(fx, fy, shear, px, py, P: SE3 | None = None,
                    dtype=torch.float32, device=None) -> "PinholeCamera":
        K = torch.tensor([[fx, shear, px], [0.0, fy, py], [0.0, 0.0, 1.0]],
                         dtype=dtype, device=device)
        if P is None:
            P = SE3.identity(dtype=dtype, device=device)
        return PinholeCamera(K, P)

    @property
    def K_inv(self) -> Tensor:
        return torch.linalg.inv(self.K)

    def project_points(self, points_world: Tensor) -> Tensor:
        """World points (..., 3) -> pixel coordinates (..., 2)."""
        p_cam = self.P.apply(points_world)
        p_norm = p_cam[..., :2] / p_cam[..., 2:3]
        p_h = torch.cat([p_norm, torch.ones_like(p_norm[..., :1])], dim=-1)
        return (p_h @ self.K.T)[..., :2]

    def point_depths(self, points_world: Tensor) -> Tensor:
        """Camera-frame z of world points (the cheirality quantity)."""
        return self.P.apply(points_world)[..., 2]

    def normalize_points(self, image_points: Tensor) -> Tensor:
        """Pixel coordinates (..., 2) -> ideal rays (..., 3), last coord 1."""
        p_h = torch.cat([image_points, torch.ones_like(image_points[..., :1])],
                        dim=-1)
        return p_h @ self.K_inv.T
