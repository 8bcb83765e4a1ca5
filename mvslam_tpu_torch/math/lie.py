"""Batched SO(3)/SE(3) Lie-group operations (port of ``mvslam_tpu.math.lie``).

Plain functions on tensors with arbitrary leading dims; Taylor fallbacks are
guarded by ``torch.where`` on safe denominators.

Conventions:
- se(3) tangent layout is **translation-first**: ``xi = [u, w]``.
- ``SE3`` acts on points as ``R @ p + t``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvslam_tpu_torch import config

Tensor = torch.Tensor


def skew(v: Tensor) -> Tensor:
    """Skew-symmetric matrix; ``skew(a) @ b == cross(a, b)``."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(M: Tensor) -> Tensor:
    """Inverse of :func:`skew` for (anti-symmetrized) matrices."""
    return torch.stack(
        [M[..., 2, 1] - M[..., 1, 2],
         M[..., 0, 2] - M[..., 2, 0],
         M[..., 1, 0] - M[..., 0, 1]],
        dim=-1,
    ) * 0.5


def _eye_like(K: Tensor) -> Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def _sincos_coeffs(theta2: Tensor, dtype) -> tuple[Tensor, Tensor, Tensor]:
    """A = sin(t)/t, B = (1-cos(t))/t^2, C = (1-A)/t^2, Taylor-guarded."""
    thr2 = config.taylor_threshold(dtype) ** 2
    small = theta2 < thr2
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t = torch.sqrt(safe_t2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe_t)) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / safe_t2)
    return A, B, C


def so3_exp(w: Tensor) -> Tensor:
    """Rodrigues' formula: axis-angle (...,3) -> rotation (...,3,3)."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sincos_coeffs(theta2, w.dtype)
    K = skew(w)
    return _eye_like(K) + A[..., None, None] * K + B[..., None, None] * (K @ K)


def so3_log(R: Tensor) -> Tensor:
    """Rotation matrix -> axis-angle; inverse of :func:`so3_exp`."""
    dtype = R.dtype
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    v = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2],
         R[..., 0, 2] - R[..., 2, 0],
         R[..., 1, 0] - R[..., 0, 1]],
        dim=-1,
    )
    thr = config.taylor_threshold(dtype)
    small = cos_theta > torch.cos(torch.tensor(thr, dtype=dtype))
    t2_small = 0.25 * torch.sum(v * v, dim=-1)
    safe_cos = torch.where(small, torch.zeros_like(cos_theta), cos_theta)
    theta = torch.arccos(safe_cos)
    sin_theta = torch.sin(theta)
    eps = config.epsilon(dtype)
    sin_theta = torch.where(torch.abs(sin_theta) < eps,
                            torch.full_like(sin_theta, eps), sin_theta)
    A = torch.where(small, (1.0 + t2_small / 6.0) * 0.5,
                    0.5 * theta / sin_theta)
    return v * A[..., None]


def so3_rectify(R: Tensor) -> Tensor:
    """Gram-Schmidt re-orthonormalization over the rows."""
    u0 = R[..., 0, :]
    u0 = u0 / torch.linalg.vector_norm(u0, dim=-1, keepdim=True)
    u1 = R[..., 1, :]
    u1 = u1 - torch.sum(u1 * u0, dim=-1, keepdim=True) * u0
    u1 = u1 / torch.linalg.vector_norm(u1, dim=-1, keepdim=True)
    u2 = torch.linalg.cross(u0, u1)
    return torch.stack([u0, u1, u2], dim=-2)


def so3_from_rpy(roll, pitch, yaw, dtype=None) -> Tensor:
    """Tait-Bryan construction ``Rz(yaw) @ Ry(pitch) @ Rx(roll)``."""
    roll, pitch, yaw = (torch.as_tensor(a, dtype=dtype)
                        for a in (roll, pitch, yaw))
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr,
                        cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr,
                        sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def so3_adjoint(R: Tensor) -> Tensor:
    """Adjoint of SO(3) is the rotation matrix itself:
    ``R exp(w^) R^T = exp((R w)^)``."""
    return R


def so3_rpy(R: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """(roll, pitch, yaw) extraction, inverse of :func:`so3_from_rpy`."""
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


def _matvec(M: Tensor, v: Tensor) -> Tensor:
    return (M @ v[..., None])[..., 0]


class SE3(NamedTuple):
    """Rigid transform: ``R`` (..., 3, 3) rotations, ``t`` (..., 3)."""

    R: Tensor
    t: Tensor

    @staticmethod
    def identity(batch_shape: tuple = (), dtype=config.DEFAULT_DTYPE,
                 device=None) -> "SE3":
        R = torch.eye(3, dtype=dtype, device=device).expand(
            batch_shape + (3, 3)).clone()
        t = torch.zeros(batch_shape + (3,), dtype=dtype, device=device)
        return SE3(R, t)

    @staticmethod
    def exp(xi: Tensor) -> "SE3":
        """Exponential map; ``xi = [u, w]`` translation-first (...,6)."""
        u, w = xi[..., :3], xi[..., 3:]
        theta2 = torch.sum(w * w, dim=-1)
        A, B, C = _sincos_coeffs(theta2, xi.dtype)
        K = skew(w)
        K2 = K @ K
        eye = _eye_like(K)
        R = eye + A[..., None, None] * K + B[..., None, None] * K2
        V = eye + B[..., None, None] * K + C[..., None, None] * K2
        return SE3(R, _matvec(V, u))

    def compose(self, other: "SE3") -> "SE3":
        return SE3(self.R @ other.R, _matvec(self.R, other.t) + self.t)

    def __matmul__(self, other: "SE3") -> "SE3":
        return self.compose(other)

    def inverse(self) -> "SE3":
        RT = self.R.transpose(-1, -2)
        return SE3(RT, -_matvec(RT, self.t))

    def apply(self, p: Tensor) -> Tensor:
        """Transform points, leading dims broadcast as in an einsum: one
        SE3 over (N, 3) points, or a (H, 1) batch over (1, N, 3)."""
        return _matvec(self.R, p) + self.t

    def log(self) -> Tensor:
        """Logarithm map -> translation-first tangent (...,6)."""
        dtype = self.R.dtype
        w = so3_log(self.R)
        theta2 = torch.sum(w * w, dim=-1)
        thr2 = config.taylor_threshold(dtype) ** 2
        small = theta2 < thr2
        safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
        safe_t = torch.sqrt(safe_t2)
        A = torch.sin(safe_t) / safe_t
        B = (1.0 - torch.cos(safe_t)) / safe_t2
        G = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                        (1.0 - 0.5 * A / B) / safe_t2)
        K = skew(w)
        V_inv = _eye_like(K) - 0.5 * K + G[..., None, None] * (K @ K)
        return torch.cat([_matvec(V_inv, self.t), w], dim=-1)

    def adjoint(self) -> Tensor:
        """(..., 6, 6) adjoint, ``T exp(xi) T^-1 = exp(adjoint() @ xi)``,
        in the translation-first layout: ``[[R, skew(t) R], [0, R]]``.
        Transports twists and, as ``Ad S Ad^T``, 6x6 covariances between
        frames."""
        top = torch.cat([self.R, skew(self.t) @ self.R], dim=-1)
        bot = torch.cat([torch.zeros_like(self.R), self.R], dim=-1)
        return torch.cat([top, bot], dim=-2)

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.R.shape[:-2])

    @staticmethod
    def from_matrix(M: Tensor) -> "SE3":
        """From (..., 4, 4) homogeneous (or (..., 3, 4)) matrices."""
        return SE3(M[..., :3, :3], M[..., :3, 3])

    def matrix(self) -> Tensor:
        """(..., 4, 4) homogeneous matrix."""
        top = self.matrix3x4()
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                              device=top.device).expand(
            top.shape[:-2] + (1, 4))
        return torch.cat([top, bottom], dim=-2)

    def matrix3x4(self) -> Tensor:
        """(..., 3, 4) projection-style matrix ``[R | t]``."""
        return torch.cat([self.R, self.t[..., None]], dim=-1)

    def to(self, dtype) -> "SE3":
        return SE3(self.R.to(dtype), self.t.to(dtype))


def se3_distance(T1: SE3, T2: SE3) -> Tensor:
    """Componentwise max ``|ln(T1) - ln(T2)|``."""
    return torch.amax(torch.abs(T1.log() - T2.log()), dim=-1)
