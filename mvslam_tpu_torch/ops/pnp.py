"""Perspective-n-Point: batched P3P-RANSAC, guarded linear DLT refit and
Gauss-Newton polish (port of ``mvslam_tpu.ops.pnp``). Returned poses are
camera-to-world."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mvslam_tpu_torch.math import linalg
from mvslam_tpu_torch.math.lie import SE3, skew
from mvslam_tpu_torch.ops import ba as ba_mod
from mvslam_tpu_torch.ops import p3p as p3p_mod
from mvslam_tpu_torch.ops import ransac as ransac_mod

Tensor = torch.Tensor

PNP_POINT_MIN = 7
PNP_REPROJ_THRESHOLD = 0.05


class PnpParams(NamedTuple):
    num_hypotheses: int = 256
    threshold: float = PNP_REPROJ_THRESHOLD   # ideal-plane reprojection
    min_inliers: int = PNP_POINT_MIN
    refit: bool = True


class PnpResult(NamedTuple):
    pose: SE3                 # camera-to-world
    inlier_mask: Tensor       # (N,)
    num_inliers: Tensor
    success: Tensor


def _pose_dlt(X: Tensor, r: Tensor, weights: Tensor) -> tuple[Tensor, Tensor]:
    """Linear camera resection on Hartley-conditioned points: world
    (..., N, 3) and image (..., N, 3) -> (R_raw (..., 3, 3), t_raw (..., 3))
    up to scale and sign."""
    dtype = X.dtype
    tiny = torch.finfo(dtype).tiny ** 0.5
    wsum = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1.0)
    cw = torch.sum(X * weights[..., None], dim=-2) / wsum
    dw = torch.linalg.vector_norm(X - cw[..., None, :], dim=-1)
    sw = math.sqrt(3.0) / torch.clamp(
        torch.sum(dw * weights, dim=-1) / wsum[..., 0], min=tiny)
    Xn = (X - cw[..., None, :]) * sw[..., None, None]
    xy = r[..., :2]
    ci = torch.sum(xy * weights[..., None], dim=-2) / wsum
    di = torch.linalg.vector_norm(xy - ci[..., None, :], dim=-1)
    si = math.sqrt(2.0) / torch.clamp(
        torch.sum(di * weights, dim=-1) / wsum[..., 0], min=tiny)
    xyn = (xy - ci[..., None, :]) * si[..., None, None]

    Xh = torch.cat([Xn, torch.ones_like(Xn[..., :1])], dim=-1)
    zeros = torch.zeros_like(Xh)
    row_x = torch.cat([-Xh, zeros, xyn[..., 0:1] * Xh], dim=-1)
    row_y = torch.cat([zeros, -Xh, xyn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([row_x, row_y], dim=-2)
    A = A * torch.cat([weights, weights], dim=-1)[..., None]
    p = linalg.smallest_eigvec_psd(A.transpose(-1, -2) @ A)
    Pn = p.reshape(p.shape[:-1] + (3, 4))
    # undo conditioning: P = T_img^-1 Pn T_world
    M = Pn[..., :3] * sw[..., None, None]
    b = Pn[..., 3] - (Pn[..., :3] @ (sw[..., None] * cw)[..., None])[..., 0]
    inv_si = 1.0 / si
    row3_M = M[..., 2, :]
    row3_b = b[..., 2]
    R_raw = torch.cat(
        [M[..., :2, :] * inv_si[..., None, None]
         + ci[..., :, None] * row3_M[..., None, :],
         row3_M[..., None, :]], dim=-2)
    t_raw = torch.cat(
        [b[..., :2] * inv_si[..., None] + ci * row3_b[..., None],
         row3_b[..., None]], dim=-1)
    return R_raw, t_raw


def _pose_from_dlt(R_raw: Tensor, t_raw: Tensor, X: Tensor,
                   weights: Tensor) -> SE3:
    """Fix scale (mean singular value) and sign (positive mean depth) of a
    raw DLT projection and project onto SE(3)."""
    dtype = R_raw.dtype
    tiny = torch.finfo(dtype).tiny
    Q = linalg.polar_orthogonal(R_raw)
    H = Q.transpose(-1, -2) @ R_raw
    scale = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / 3.0
    _, v = linalg.eigh3x3_smallest(0.5 * (H + H.transpose(-1, -2)))
    flip_R = torch.eye(3, dtype=dtype, device=R_raw.device) \
        - 2.0 * v[..., :, None] * v[..., None, :]
    detQ = linalg.det3(Q)

    def nearest_rotation(f):
        Qf = Q * f[..., None, None]
        return torch.where((detQ * f > 0)[..., None, None], Qf, Qf @ flip_R)

    ones = torch.ones(R_raw.shape[:-2], dtype=dtype, device=R_raw.device)
    R = nearest_rotation(ones)
    t = t_raw / torch.clamp(scale, min=tiny)[..., None]
    depth = torch.sum(R[..., None, 2, :] * X, dim=-1) + t[..., None, 2]
    flip = torch.where(torch.sum(depth * weights, dim=-1) < 0, -ones, ones)
    R = nearest_rotation(flip)
    t = (t_raw * flip[..., None]) / torch.clamp(scale, min=tiny)[..., None]
    return SE3(R, t).inverse()


def refine_pose_gn(pose: SE3, X: Tensor, r: Tensor, weights: Tensor,
                   iterations: int = 3) -> SE3:
    """Fixed-iteration pose-only Gauss-Newton on reprojection residuals."""
    dtype = X.dtype
    eps = torch.finfo(dtype).eps
    eye6 = torch.eye(6, dtype=dtype, device=X.device)
    R, t = pose.R, pose.t
    for _ in range(iterations):
        pose_i = SE3(R, t)
        Xc = pose_i.inverse().apply(X)
        z = Xc[..., 2]
        safe_z = torch.where(torch.abs(z) < 1e3 * eps,
                             torch.full_like(z, 1e3 * eps), z)
        inv_z = 1.0 / safe_z
        res = (Xc[..., :2] * inv_z[..., None] - r[..., :2]) * weights[..., None]
        zero = torch.zeros_like(inv_z)
        dproj = torch.stack(
            [torch.stack([inv_z, zero, -Xc[..., 0] * inv_z * inv_z], dim=-1),
             torch.stack([zero, inv_z, -Xc[..., 1] * inv_z * inv_z], dim=-1)],
            dim=-2)
        J = torch.cat([-dproj, dproj @ skew(Xc)], dim=-1)
        J = J * weights[..., None, None]
        H = torch.einsum("...nki,...nkj->...ij", J, J)
        g = -torch.einsum("...nki,...nk->...i", J, res)
        jitter = eps * (1.0 + torch.amax(torch.abs(H), dim=(-2, -1)))
        delta = linalg.solve_psd(H + jitter[..., None, None] * eye6, g)
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        new = pose_i.compose(SE3.exp(delta))
        R, t = new.R, new.t
    return SE3(R, t)


def _camera_error_sq(Xc: Tensor, r: Tensor) -> Tensor:
    """Squared ideal-plane error of camera-frame points; +inf behind."""
    z = Xc[..., 2]
    eps = torch.finfo(Xc.dtype).eps
    safe_z = torch.where(torch.abs(z) < 1e3 * eps,
                         torch.full_like(z, 1e3 * eps), z)
    err = torch.sum((Xc[..., :2] / safe_z[..., None] - r[..., :2]) ** 2, dim=-1)
    return torch.where(z > 0, err, torch.full_like(err, math.inf))


def reprojection_error_sq(pose: SE3, X: Tensor, r: Tensor) -> Tensor:
    """Squared ideal-plane reprojection error of world points (N, 3) under
    a camera-to-world pose, (N,); behind-camera points are +inf."""
    return _camera_error_sq(pose.inverse().apply(X), r)


def pnp_ransac_core(X: Tensor, r: Tensor, mask: Tensor, num_hypotheses: int,
                    thr_sq, refit: bool = True,
                    generator: torch.Generator | None = None,
                    uniforms: Tensor | None = None) -> tuple[SE3, Tensor]:
    """P3P-RANSAC + guarded DLT refit + Gauss-Newton polish. X (N, 3)
    world points, r (N, 3) rays. Returns (pose, inlier mask). The minimal
    sets come from ``uniforms`` (num_hypotheses, N) or ``generator``."""
    dtype = X.dtype
    tiny = torch.finfo(dtype).tiny ** 0.5
    if uniforms is not None and tuple(uniforms.shape) != (num_hypotheses,
                                                          X.shape[0]):
        raise ValueError(f"uniforms of shape {tuple(uniforms.shape)}, the "
                         f"PnP draws are ({num_hypotheses}, {X.shape[0]})")
    idx = ransac_mod.sample_minimal_sets(mask, num_hypotheses, 3, generator,
                                         uniforms)
    Xs, rs = X[idx], r[idx]
    bear = rs / torch.clamp(torch.linalg.vector_norm(rs, dim=-1, keepdim=True),
                            min=tiny)
    cand, cand_valid = p3p_mod.p3p_solve(Xs, bear)          # (H, 12)
    HC = num_hypotheses * cand_valid.shape[-1]
    poses = SE3(cand.R.reshape(HC, 3, 3), cand.t.reshape(HC, 3))
    flat_valid = cand_valid.reshape(HC)
    inv = poses.inverse()
    Xc = torch.einsum("hij,nj->hni", inv.R, X) + inv.t[:, None, :]
    errors = _camera_error_sq(Xc, r[None])                   # (HC, N)
    errors = torch.where(flat_valid[:, None], errors,
                         torch.full_like(errors, math.inf))
    best, inl, _ = ransac_mod._select_best(errors, mask, thr_sq)
    pose = SE3(ransac_mod.take_best(poses.R, best),
               ransac_mod.take_best(poses.t, best))
    best_inl = ransac_mod.take_best(inl, best)

    if refit:
        # linear DLT refit over the consensus set; a degenerate (planar) set
        # gives a garbage pose that loses the inlier comparison below
        wf = best_inl.to(dtype)
        R_raw, t_raw = _pose_dlt(X, r, wf)
        pose_fit = _pose_from_dlt(R_raw, t_raw, X, wf)
        fin = torch.all(torch.isfinite(pose_fit.R)) & torch.all(
            torch.isfinite(pose_fit.t))
        pose_fit = SE3(torch.where(fin, pose_fit.R, pose.R),
                       torch.where(fin, pose_fit.t, pose.t))
        inl_fit = (reprojection_error_sq(pose_fit, X, r) < thr_sq) & mask
        better = fin & (torch.sum(inl_fit) > torch.sum(best_inl))
        pose = SE3(torch.where(better, pose_fit.R, pose.R),
                   torch.where(better, pose_fit.t, pose.t))
        best_inl = torch.where(better, inl_fit, best_inl)

    pose = refine_pose_gn(pose, X, r, best_inl.to(dtype))
    best_inl = (reprojection_error_sq(pose, X, r) < thr_sq) & mask
    return pose, best_inl


def pnp_solve(X: Tensor, r: Tensor, mask: Tensor,
              params: PnpParams = PnpParams(),
              generator: torch.Generator | None = None,
              uniforms: Tensor | None = None) -> PnpResult:
    """Camera pose from 3D-2D matches by batched P3P-RANSAC. X (N, 3)
    world points, r (N, 3) homogeneous ideal-plane observations, mask (N,)
    valid correspondences; the draws come from ``uniforms``
    (num_hypotheses, N) or ``generator`` (the JAX package's ``key``)."""
    pose, best_inl = pnp_ransac_core(
        X, r, mask, params.num_hypotheses,
        params.threshold * params.threshold, params.refit,
        generator=generator, uniforms=uniforms)
    num = torch.sum(best_inl).to(torch.int32)
    return PnpResult(pose=pose, inlier_mask=best_inl, num_inliers=num,
                     success=num >= params.min_inliers)


def pnp_refine(pose0: SE3, pose0_info: Tensor, X: Tensor, X_info: Tensor,
               r: Tensor, obs_weight: Tensor, mask: Tensor,
               ba_params: ba_mod.BAParams = ba_mod.BAParams()
               ) -> tuple[SE3, Tensor, Tensor]:
    """Motion-(mostly-)only BA: one frame regulated by its own prior
    (``pose0_info``) + N points carrying priors from their estimates
    (``X_info`` = inverse covariances); points are optimized but not
    returned. Returns (refined pose, pose covariance (6, 6), final
    error)."""
    poses0 = SE3(pose0.R[None], pose0.t[None])
    prob = ba_mod.BAProblem.create(
        poses0=poses0, points0=X, obs=r[None, :, :2], obs_mask=mask[None],
        obs_weight=obs_weight[None], pose_prior=poses0,
        pose_prior_info=pose0_info[None], point_prior=X,
        point_prior_info=X_info)
    result = ba_mod.ba_solve(prob, ba_params)
    return (SE3(result.poses.R[0], result.poses.t[0]),
            result.pose_covariance[0], result.error)
