"""Vectorized RANSAC: all hypotheses as one batched computation (port of
``mvslam_tpu.ops.ransac``, essential-matrix path).

Minimal sets are the top-k of per-hypothesis iid uniforms with invalid
points pinned to -inf (distinct valid indices per hypothesis). The
uniforms come from a ``torch.Generator``, or are passed in: given the
JAX package's own uniforms, the same indices come out.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mvslam_tpu_torch.ops import epipolar

Tensor = torch.Tensor


def sample_minimal_sets(mask: Tensor, num_sets: int, k: int,
                        generator: torch.Generator | None = None,
                        uniforms: Tensor | None = None) -> Tensor:
    """``num_sets`` index sets of ``k`` distinct valid points: (num_sets, k).

    ``uniforms`` (num_sets, N) replaces the draw from ``generator``. Ties
    (the -inf of invalid points) keep the lower index first, as
    ``jax.lax.top_k``."""
    n = mask.shape[-1]
    if uniforms is None:
        uniforms = torch.rand((num_sets, n), generator=generator,
                              device=mask.device)
    g = torch.where(mask[None, :], uniforms,
                    torch.full_like(uniforms, -math.inf))
    _, idx = torch.sort(g, dim=-1, descending=True, stable=True)
    return idx[:, :k]


class RansacResult(NamedTuple):
    model: Tensor          # best model parameters
    inlier_mask: Tensor    # (N,) bool
    num_inliers: Tensor    # () int32
    residuals: Tensor      # (N,)


def _select_best(errors: Tensor, mask: Tensor, threshold_sq):
    """errors (H, N) -> (best index, inlier mask (H, N), counts (H,)),
    best by (max inlier count, then min inlier error sum)."""
    inl = (errors < threshold_sq) & mask[None, :]
    counts = torch.sum(inl, dim=-1)
    err_sum = torch.sum(torch.where(inl, errors, torch.zeros_like(errors)),
                        dim=-1)
    score = counts.to(errors.dtype) - err_sum / (
        1.0 + errors.shape[-1] * threshold_sq)
    return torch.argmax(score), inl, counts


def essential_ransac(r1: Tensor, r2: Tensor, mask: Tensor,
                     num_hypotheses: int = 256, threshold_sq=5e-2,
                     refit: bool = True,
                     generator: torch.Generator | None = None,
                     uniforms: Tensor | None = None) -> RansacResult:
    """Essential matrix from ideal-camera rays (N, 3) by batched 8-point
    RANSAC on the squared Sampson error, then (``refit``) three IRLS
    Sampson-weighted refits on the consensus set, kept only if they lose no
    inliers."""
    idx = sample_minimal_sets(mask, num_hypotheses, 8, generator, uniforms)
    s1, s2 = r1[idx], r2[idx]
    w = torch.ones(idx.shape, dtype=r1.dtype, device=r1.device)
    Es = epipolar.find_essential_matrix(s1, s2, w)
    errors = epipolar.sampson_error(Es, r1[None], r2[None])
    best, inl, _ = _select_best(errors, mask, threshold_sq)
    E = Es[best]
    best_inl = inl[best]

    if refit:
        E_fit, inl_fit = E, best_inl
        for _ in range(3):
            w_geo = torch.sqrt(epipolar.sampson_weights(E_fit, r1, r2)) \
                * inl_fit.to(r1.dtype)
            E_fit = epipolar.find_essential_matrix(r1, r2, w_geo,
                                                   use_eigh=True)
            err_fit = epipolar.sampson_error(E_fit, r1, r2)
            inl_fit = (err_fit < threshold_sq) & mask
        better = torch.sum(inl_fit) >= torch.sum(best_inl)
        E = torch.where(better, E_fit, E)
        best_inl = torch.where(better, inl_fit, best_inl)

    return RansacResult(
        model=E, inlier_mask=best_inl,
        num_inliers=torch.sum(best_inl).to(torch.int32),
        residuals=epipolar.sampson_error(E, r1, r2),
    )
