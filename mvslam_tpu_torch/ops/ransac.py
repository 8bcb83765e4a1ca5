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

from mvslam_tpu_torch.math import linalg
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


def take_best(x: Tensor, best: Tensor) -> Tensor:
    """``x[best]`` for a 0-dim index tensor, kept on the device: indexing
    with a 0-dim tensor reads it on the host first (a synchronisation)."""
    return x.index_select(0, best.reshape(1))[0]


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


#: the IRLS refits of ``essential_ransac``'s ``refit``
ESSENTIAL_REFITS = 3


def essential_hypotheses(r1: Tensor, r2: Tensor, mask: Tensor,
                         num_hypotheses: int = 256, threshold_sq=5e-2,
                         generator: torch.Generator | None = None,
                         uniforms: Tensor | None = None
                         ) -> tuple[Tensor, Tensor]:
    """``essential_ransac``'s batched 8-point hypotheses and the best of
    them by the squared Sampson error: (E, its inlier mask (N,))."""
    idx = sample_minimal_sets(mask, num_hypotheses, 8, generator, uniforms)
    s1, s2 = r1[idx], r2[idx]
    w = torch.ones(idx.shape, dtype=r1.dtype, device=r1.device)
    Es = epipolar.find_essential_matrix(s1, s2, w)
    errors = epipolar.sampson_error(Es, r1[None], r2[None])
    best, inl, _ = _select_best(errors, mask, threshold_sq)
    return take_best(Es, best), take_best(inl, best)


def refit_gram(E_fit: Tensor, inl_fit: Tensor, r1: Tensor, r2: Tensor
               ) -> tuple[Tensor, Tensor]:
    """One IRLS refit up to its ``eigh``: the Sampson weights of the
    consensus set and their DLT's Gram matrix, (N,) and (9, 9)."""
    w_geo = torch.sqrt(epipolar.sampson_weights(E_fit, r1, r2)) \
        * inl_fit.to(r1.dtype)
    return w_geo, epipolar.essential_gram(r1, r2, w_geo)


def refit_solve(V: Tensor, w_geo: Tensor, r1: Tensor, r2: Tensor,
                mask: Tensor, threshold_sq) -> tuple[Tensor, Tensor]:
    """One IRLS refit after its ``eigh`` (eigenvectors ``V`` of
    :func:`refit_gram`'s matrix): the refit E and its inlier mask."""
    E_fit = epipolar.essential_of_eigvecs(V, r1, r2, w_geo)
    err_fit = epipolar.sampson_error(E_fit, r1, r2)
    return E_fit, (err_fit < threshold_sq) & mask


def keep_refit(E: Tensor, best_inl: Tensor, E_fit: Tensor, inl_fit: Tensor,
               r1: Tensor, r2: Tensor) -> RansacResult:
    """The refit where it loses no inliers, else the hypothesis."""
    better = torch.sum(inl_fit) >= torch.sum(best_inl)
    return essential_result(torch.where(better, E_fit, E),
                            torch.where(better, inl_fit, best_inl), r1, r2)


def essential_result(E: Tensor, inl: Tensor, r1: Tensor, r2: Tensor
                     ) -> RansacResult:
    """``essential_ransac``'s result for the model ``E`` and its inliers."""
    return RansacResult(
        model=E, inlier_mask=inl,
        num_inliers=torch.sum(inl).to(torch.int32),
        residuals=epipolar.sampson_error(E, r1, r2),
    )


def essential_ransac(r1: Tensor, r2: Tensor, mask: Tensor,
                     num_hypotheses: int = 256, threshold_sq=5e-2,
                     refit: bool = True,
                     generator: torch.Generator | None = None,
                     uniforms: Tensor | None = None) -> RansacResult:
    """Essential matrix from ideal-camera rays (N, 3) by batched 8-point
    RANSAC on the squared Sampson error, then (``refit``) three IRLS
    Sampson-weighted refits on the consensus set, kept only if they lose no
    inliers. Composed of :func:`essential_hypotheses`, per refit
    :func:`refit_gram`, ``eigh`` and :func:`refit_solve`, then
    :func:`keep_refit`."""
    E, best_inl = essential_hypotheses(r1, r2, mask, num_hypotheses,
                                       threshold_sq, generator, uniforms)
    if not refit:
        return essential_result(E, best_inl, r1, r2)
    E_fit, inl_fit = E, best_inl
    for _ in range(ESSENTIAL_REFITS):
        w_geo, gram = refit_gram(E_fit, inl_fit, r1, r2)
        _, V = linalg.eigh(gram)                # ascending eigenvalues
        E_fit, inl_fit = refit_solve(V, w_geo, r1, r2, mask, threshold_sq)
    return keep_refit(E, best_inl, E_fit, inl_fit, r1, r2)


def fundamental_ransac(p1: Tensor, p2: Tensor, mask: Tensor,
                       num_hypotheses: int = 256, max_error: float = 5.0,
                       refit: bool = True,
                       generator: torch.Generator | None = None,
                       uniforms: Tensor | None = None) -> RansacResult:
    """Pixel-space fundamental-matrix RANSAC: 8-point minimal samples,
    inlier test on the algebraic residual ``|p2^T F p1| < max_error``
    (linear in the residual, not squared), best model by (inlier count,
    then total residual); ``refit`` adds one eigh refit on the consensus
    set, kept if it loses no inliers. p1, p2: (N, 2) pixel coordinates."""
    h1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    h2 = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)
    idx = sample_minimal_sets(mask, num_hypotheses, 8, generator, uniforms)
    w = torch.ones(idx.shape, dtype=p1.dtype, device=p1.device)
    Fs = epipolar.find_fundamental_matrix(p1[idx], p2[idx], w)
    errors = epipolar.epipolar_residual(Fs, h1[None], h2[None])
    best, inl, _ = _select_best(errors, mask, max_error)
    F = take_best(Fs, best)
    best_inl = take_best(inl, best)

    if refit:
        F_fit = epipolar.find_fundamental_matrix(
            p1, p2, best_inl.to(p1.dtype), use_eigh=True)
        err_fit = epipolar.epipolar_residual(F_fit, h1, h2)
        inl_fit = (err_fit < max_error) & mask
        better = torch.sum(inl_fit) >= torch.sum(best_inl)
        F = torch.where(better, F_fit, F)
        best_inl = torch.where(better, inl_fit, best_inl)

    return RansacResult(
        model=F, inlier_mask=best_inl,
        num_inliers=torch.sum(best_inl).to(torch.int32),
        residuals=epipolar.epipolar_residual(F, h1, h2),
    )
