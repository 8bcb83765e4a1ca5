"""Pinhole camera model (port of ``mvslam_tpu.ops.camera``): intrinsics
``K`` and world->camera extrinsics ``P``, batched project/normalize, and
the text-file format ``camera.config``: line 1 = ``fx fy shear px py``,
line 2 = the 6-dof se3 of ``P`` (translation-first tangent)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mvslam_tpu_torch.math.lie import SE3

Tensor = torch.Tensor


class PinholeCamera(NamedTuple):
    """Camera = intrinsics (3, 3) + world->camera SE3."""

    K: Tensor
    P: SE3

    @staticmethod
    def create(K=None, P: SE3 | None = None, dtype=torch.float32,
               device=None) -> "PinholeCamera":
        """From a 3x3 intrinsics array (identity when None) and an
        extrinsic (identity when None)."""
        if K is None:
            K = torch.eye(3, dtype=dtype, device=device)
        else:
            K = torch.as_tensor(K, dtype=dtype, device=device)
        if P is None:
            P = SE3.identity(dtype=dtype, device=device)
        return PinholeCamera(K, P)

    @staticmethod
    def from_params(fx, fy, shear, px, py, P: SE3 | None = None,
                    dtype=torch.float32, device=None) -> "PinholeCamera":
        K = torch.tensor([[fx, shear, px], [0.0, fy, py], [0.0, 0.0, 1.0]],
                         dtype=dtype, device=device)
        if P is None:
            P = SE3.identity(dtype=dtype, device=device)
        return PinholeCamera(K, P)

    def to(self, device) -> "PinholeCamera":
        """The same camera with its tensors on ``device``."""
        return PinholeCamera(self.K.to(device),
                             SE3(self.P.R.to(device), self.P.t.to(device)))

    @property
    def K_inv(self) -> Tensor:
        # the unchecked inverse: ``torch.linalg.inv`` reads its error flag
        # on the host, a synchronisation per call on the card
        return torch.linalg.inv_ex(self.K).inverse

    @property
    def P_inv(self) -> SE3:
        return self.P.inverse()

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

    # -- IO (host-side text format) -------------------------------------------
    def save_to_file(self, filename: str) -> None:
        K = self.K.detach().cpu().numpy().astype(np.float64)
        se3 = self.P.log().detach().cpu().numpy().astype(np.float64)
        with open(filename, "w") as f:
            f.write(f"{K[0,0]:.17g} {K[1,1]:.17g} {K[0,1]:.17g} "
                    f"{K[0,2]:.17g} {K[1,2]:.17g}\n")
            f.write(" ".join(f"{v:.17g}" for v in se3) + "\n")

    @staticmethod
    def load_from_file(filename: str, dtype=torch.float32,
                       device=None) -> "PinholeCamera":
        with open(filename, "r") as f:
            values = f.read().split()
        fx, fy, shear, px, py = (float(v) for v in values[:5])
        se3 = np.array([float(v) for v in values[5:11]], dtype=np.float64)
        P = SE3.exp(torch.tensor(se3, dtype=dtype, device=device))
        return PinholeCamera.from_params(fx, fy, shear, px, py, P,
                                         dtype=dtype, device=device)
