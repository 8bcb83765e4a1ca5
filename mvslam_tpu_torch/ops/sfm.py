"""Two-view structure from motion: pose recovery, triangulation under a
known pose, two-view bundle adjustment (port of ``mvslam_tpu.ops.sfm``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops import ba as ba_mod
from mvslam_tpu_torch.ops import epipolar, ransac, triangulate
from mvslam_tpu_torch.ops.ransac import take_best

Tensor = torch.Tensor

#: reference constants (vision/sfm-solve.cpp:18-23, sfm-refine.cpp:11-18)
MAX_ERROR_SQ = 5e-2
VF_MATCH_INLIER_MIN = 8
ANCHOR_STDDEV = 1e-5
REGULATOR_STDDEV = 1e-2


def _identity_projection(like: Tensor) -> Tensor:
    return torch.eye(3, 4, dtype=like.dtype, device=like.device)


def recover_pose_and_points(E: Tensor, r1: Tensor, r2: Tensor,
                            inlier_mask: Tensor, min_depth: float = 0.0):
    """Choose among the 4 (R, t) decompositions of E by cheirality vote.
    Returns (pose2in1, points (N, 3) in frame 1, point_mask)."""
    Rs, ts = epipolar.decompose_essential_matrix(E)
    P1s = _identity_projection(E).expand(4, 3, 4)
    P2s = torch.cat([Rs, ts[..., None]], dim=-1)
    X = triangulate.triangulate_dlt(P1s, P2s, r1[None], r2[None])
    front = triangulate.cheirality_mask(P1s, P2s, X, min_depth)
    good = front & inlier_mask[None, :]
    best = torch.argmax(torch.sum(good, dim=-1))
    pose2in1 = SE3(take_best(Rs, best), take_best(ts, best)).inverse()
    return pose2in1, take_best(X, best), take_best(good, best)


class SfmParams(NamedTuple):
    """Static solve configuration (shapes and budgets are Python ints)."""

    num_hypotheses: int = 256
    threshold_sq: float = MAX_ERROR_SQ   # squared ideal-plane units
    min_inliers: int = VF_MATCH_INLIER_MIN
    min_depth: float = 0.0               # cheirality lower bound
    refit: bool = True
    polish: bool = True                  # Sampson GN on the recovered pose
    polish_iterations: int = 6


class SfmResult(NamedTuple):
    """Everything ``sfm_solve`` recovers. ``pose2in1``: frame-2 camera pose
    in frame 1, translation unit-norm (scale is unobservable). ``points``:
    (N, 3) in frame-1 coordinates, valid where ``point_mask``.
    ``success``: enough inliers survived."""

    pose2in1: SE3
    points: Tensor
    point_mask: Tensor
    inlier_mask: Tensor
    num_inliers: Tensor
    num_points: Tensor
    E: Tensor
    success: Tensor


def sfm_solve(r1: Tensor, r2: Tensor, mask: Tensor,
              params: SfmParams = SfmParams(),
              generator: torch.Generator | None = None,
              uniforms: Tensor | None = None) -> SfmResult:
    """Two-view bootstrap from matched ideal-camera rays (N, 3): essential
    matrix by RANSAC, pose and points by cheirality vote, then
    (``polish``) a Sampson polish of the pose and a re-triangulation
    against it. The RANSAC draws come from ``uniforms``
    (num_hypotheses, N) or ``generator`` (the JAX package's ``key``)."""
    rr = ransac.essential_ransac(
        r1, r2, mask, num_hypotheses=params.num_hypotheses,
        threshold_sq=params.threshold_sq, refit=params.refit,
        generator=generator, uniforms=uniforms)
    pose2in1, points, point_mask = recover_pose_and_points(
        rr.model, r1, r2, rr.inlier_mask, params.min_depth)
    E = rr.model
    if params.polish:
        pose2in1 = epipolar.refine_relative_pose_sampson(
            pose2in1, r1, r2, rr.inlier_mask.to(r1.dtype),
            iterations=params.polish_iterations)
        E = epipolar.essential_from_pose(pose2in1)
        points, point_mask = sfm_triangulate(r1, r2, rr.inlier_mask,
                                             pose2in1, params.min_depth)
    return SfmResult(
        pose2in1=pose2in1, points=points, point_mask=point_mask,
        inlier_mask=rr.inlier_mask, num_inliers=rr.num_inliers,
        num_points=torch.sum(point_mask).to(torch.int32), E=E,
        success=rr.num_inliers >= params.min_inliers,
    )


class SfmRefineResult(NamedTuple):
    pose2in1: SE3
    pose_covariance: Tensor
    points: Tensor
    point_covariance: Tensor
    point_mask: Tensor
    error: Tensor
    iterations: Tensor
    converged: Tensor
    point_information: Tensor | None = None


def sfm_refine(r1: Tensor, r2: Tensor, mask: Tensor, pose2in1: SE3,
               points: Tensor, obs_stddev=1.0,
               ba_params: ba_mod.BAParams = ba_mod.BAParams(),
               anchor_stddev: float = ANCHOR_STDDEV,
               regulator_stddev: float = REGULATOR_STDDEV,
               gauge: str = "regulator") -> SfmRefineResult:
    """Two-view bundle adjustment: frame 0 anchored at the origin; the
    scale gauge fixed by weak regulator priors (``"regulator"``) or by one
    tight prior on the frame-1 translation's own direction
    (``"scale_only"``). ``obs_stddev``: scalar, (N,) or per-frame (2, N)."""
    dtype, dev = points.dtype, points.device
    n = points.shape[0]
    sig_in = torch.as_tensor(obs_stddev, dtype=dtype, device=dev)
    if sig_in.dim() == 2:
        obs_weight = 1.0 / sig_in
    else:
        sig = sig_in.expand(n)
        obs_weight = torch.stack([1.0 / sig, 1.0 / sig])
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    poses0 = SE3(torch.stack([eye3, pose2in1.R]),
                 torch.stack([torch.zeros_like(pose2in1.t), pose2in1.t]))
    anchor_info = 1.0 / (anchor_stddev * anchor_stddev)
    reg_info = 1.0 / (regulator_stddev * regulator_stddev)
    if gauge == "regulator":
        frame1_info = reg_info * eye6
        point_prior_info = (reg_info * eye3).expand(n, 3, 3)
    elif gauge == "scale_only":
        t_norm = torch.linalg.vector_norm(pose2in1.t)
        t_hat = pose2in1.t / torch.clamp(t_norm, min=torch.finfo(dtype).tiny)
        u_dir = pose2in1.R.T @ t_hat
        frame1_info = torch.zeros((6, 6), dtype=dtype, device=dev)
        frame1_info[:3, :3] = anchor_info * torch.outer(u_dir, u_dir)
        point_prior_info = torch.zeros((n, 3, 3), dtype=dtype, device=dev)
    else:
        raise ValueError(f"unknown gauge {gauge!r}")
    prob = ba_mod.BAProblem.create(
        poses0=poses0, points0=points,
        obs=torch.stack([r1[:, :2], r2[:, :2]]),
        obs_mask=torch.stack([mask, mask]),
        obs_weight=obs_weight,
        pose_prior=poses0,
        pose_prior_info=torch.stack([anchor_info * eye6, frame1_info]),
        point_prior=points, point_prior_info=point_prior_info,
    )
    result = ba_mod.ba_solve(prob, ba_params)
    return SfmRefineResult(
        pose2in1=SE3(result.poses.R[1], result.poses.t[1]),
        pose_covariance=result.pose_covariance[1],
        points=result.points,
        point_covariance=result.point_covariance,
        point_mask=mask,
        error=result.error,
        iterations=result.iterations,
        converged=result.converged,
        point_information=result.point_information,
    )


def sfm_triangulate(r1: Tensor, r2: Tensor, mask: Tensor, pose2in1: SE3,
                    min_depth: float = 0.0) -> tuple[Tensor, Tensor]:
    """Triangulate matched rays under a known relative pose: (points (N, 3)
    in frame 1, mask & cheirality in both cameras)."""
    P1 = _identity_projection(r1)
    P2 = pose2in1.inverse().matrix3x4()
    X = triangulate.triangulate_dlt(P1, P2, r1, r2)
    return X, triangulate.cheirality_mask(P1, P2, X, min_depth) & mask
