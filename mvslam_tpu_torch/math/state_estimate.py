"""Gaussian state estimates: mean + covariance tuples (port of
``mvslam_tpu.math.state_estimate``); ``info()`` is the inverse covariance,
batched over leading axes."""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvslam_tpu_torch.math.lie import SE3

Tensor = torch.Tensor


class StateEstimate(NamedTuple):
    """A Gaussian random variable: ``mean`` (..., N) + ``covar`` (..., N, N)."""

    mean: Tensor
    covar: Tensor

    def info(self) -> Tensor:
        """Information matrix (inverse covariance), batched. A singular
        covariance gives non-finite entries, as ``jnp.linalg.inv`` does; the
        unchecked inverse reads no error flag back to the host."""
        return torch.linalg.inv_ex(self.covar).inverse


class TransformationEstimate(NamedTuple):
    """SE3-valued Gaussian: mean pose + 6x6 covariance in the tangent space
    (translation-first layout)."""

    mean: SE3
    covar: Tensor               # (..., 6, 6)

    def info(self) -> Tensor:
        return torch.linalg.inv_ex(self.covar).inverse


def _isotropic(mean: Tensor, n: int, stddev: float | None) -> Tensor:
    s = 1.0 if stddev is None else stddev
    eye = torch.eye(n, dtype=mean.dtype, device=mean.device)
    return ((s * s) * eye).expand(mean.shape + (n,))


def point3_estimate(mean: Tensor, covar: Tensor | None = None,
                    stddev: float | None = None) -> StateEstimate:
    """(..., 3) point estimate; isotropic covariance from ``stddev`` if no
    full covariance is given."""
    if covar is None:
        covar = _isotropic(mean, 3, stddev)
    return StateEstimate(mean, covar)


def point2_estimate(mean: Tensor, covar: Tensor | None = None,
                    stddev: float | None = None) -> StateEstimate:
    """(..., 2) point estimate (the per-keypoint isotropic sigma model
    produces these)."""
    if covar is None:
        covar = _isotropic(mean, 2, stddev)
    return StateEstimate(mean, covar)
