"""Levenberg-Marquardt bundle adjustment with landmark Schur complement
(port of ``mvslam_tpu.ops.ba``).

Dense, statically-shaped problem: F camera-to-world poses, P points,
(F, P, 2) ideal-plane observations with mask and 1/sigma weights, and
information-form priors. Each LM iteration builds the block normal
equations analytically, eliminates the landmarks with batched closed-form
3x3 inverses and solves the reduced 6F system by Cholesky.

The JAX ``while_loop`` with an early stop becomes ``max_iterations``
iterations in which every carried value is frozen by ``torch.where`` once
``done`` is set — the same result with no host read.

With a process ``group`` (the JAX ``axis_name``), each rank holds a
contiguous block of the landmarks and the same poses: the pose blocks of
the normal equations, the reduced camera system and the cost's landmark
terms are summed over the group (:func:`psum`), every rank solves the same
camera system, and pose priors are added once, after the sums
(``parallel/dist_ba.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from mvslam_tpu_torch.math import linalg
from mvslam_tpu_torch.math.lie import SE3, skew

Tensor = torch.Tensor


class BAProblem(NamedTuple):
    """``obs`` (F, P, 2), ``obs_mask`` (F, P) bool, ``obs_weight`` (F, P)
    1/sigma; priors in information form (zero info = no prior)."""

    poses0: SE3
    points0: Tensor
    obs: Tensor
    obs_mask: Tensor
    obs_weight: Tensor
    pose_prior: SE3
    pose_prior_info: Tensor
    point_prior: Tensor
    point_prior_info: Tensor

    @staticmethod
    def create(poses0: SE3, points0: Tensor, obs: Tensor, obs_mask: Tensor,
               obs_weight: Tensor | None = None,
               pose_prior: SE3 | None = None,
               pose_prior_info: Tensor | None = None,
               point_prior: Tensor | None = None,
               point_prior_info: Tensor | None = None) -> "BAProblem":
        dtype, dev = points0.dtype, points0.device
        F = poses0.t.shape[0]
        P = points0.shape[0]
        if obs_weight is None:
            obs_weight = torch.ones((F, P), dtype=dtype, device=dev)
        if pose_prior is None:
            pose_prior = SE3.identity((F,), dtype=dtype, device=dev)
        if pose_prior_info is None:
            pose_prior_info = torch.zeros((F, 6, 6), dtype=dtype, device=dev)
        if point_prior is None:
            point_prior = torch.zeros((P, 3), dtype=dtype, device=dev)
        if point_prior_info is None:
            point_prior_info = torch.zeros((P, 3, 3), dtype=dtype, device=dev)
        return BAProblem(poses0, points0, obs, obs_mask.to(torch.bool),
                         obs_weight, pose_prior, pose_prior_info,
                         point_prior, point_prior_info)


class BAParams(NamedTuple):
    max_iterations: int = 50
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    lambda_min: float = 1e-12
    lambda_max: float = 1e8
    rel_decrease: float = 1e-8
    abs_decrease: float = 0.0
    compute_covariance: bool = True
    compute_point_info: bool = False
    # Huber threshold on the whitened residual norm (sigmas); None = Gaussian
    huber_delta: float | None = None


class BAResult(NamedTuple):
    poses: SE3
    points: Tensor
    pose_covariance: Tensor
    point_covariance: Tensor
    error: Tensor
    iterations: Tensor
    converged: Tensor
    point_information: Tensor | None = None


def _projection_residuals(poses: SE3, points: Tensor, prob: BAProblem,
                          huber_delta: float | None = None):
    """Weighted residuals r (F, P, 2) and Jacobian blocks Jc (F, P, 2, 6),
    Jp (F, P, 2, 3), pre-masked and pre-weighted (IRLS-scaled with Huber)."""
    dtype = points.dtype
    R, t = poses.R, poses.t
    diff = points[None, :, :] - t[:, None, :]
    Xc = torch.einsum("fji,fpj->fpi", R, diff)
    z = Xc[..., 2]
    eps = torch.finfo(dtype).eps
    safe_z = torch.where(torch.abs(z) < 1e3 * eps,
                         torch.full_like(z, 1e3 * eps), z)
    proj = Xc[..., :2] / safe_z[..., None]
    w = torch.where(prob.obs_mask, prob.obs_weight,
                    torch.zeros_like(prob.obs_weight))
    r = (proj - prob.obs) * w[..., None]

    inv_z = 1.0 / safe_z
    zero = torch.zeros_like(inv_z)
    dproj = torch.stack(
        [torch.stack([inv_z, zero, -Xc[..., 0] * inv_z * inv_z], dim=-1),
         torch.stack([zero, inv_z, -Xc[..., 1] * inv_z * inv_z], dim=-1)],
        dim=-2,
    )
    # dX_c/d delta with T <- T exp([u, w]):  du -> -I, dw -> skew(X_c)
    Jc = torch.cat([-dproj, dproj @ skew(Xc)], dim=-1)
    Jp = torch.einsum("fpij,fkj->fpik", dproj, R)
    Jc = Jc * w[..., None, None]
    Jp = Jp * w[..., None, None]
    if huber_delta is not None:
        tiny = torch.finfo(dtype).tiny ** 0.5
        nrm = torch.linalg.vector_norm(r, dim=-1)
        wr = torch.sqrt(torch.clamp(huber_delta / torch.clamp(nrm, min=tiny),
                                    max=1.0))
        r = r * wr[..., None]
        Jc = Jc * wr[..., None, None]
        Jp = Jp * wr[..., None, None]
    return r, Jc, Jp


def _prior_residuals(poses: SE3, points: Tensor, prob: BAProblem):
    """Pose prior ``ln(prior^-1 . T)`` (F, 6) and point prior (P, 3)."""
    r_pose = prob.pose_prior.inverse().compose(poses).log()
    return r_pose, points - prob.point_prior


def psum(x: Tensor, group=None) -> Tensor:
    """``x`` summed over the ranks of the process ``group`` (every rank gets
    the sum, the JAX ``psum``); ``x`` itself when ``group`` is None. The
    reduce works on a contiguous copy."""
    if group is None:
        return x
    y = torch.clone(x, memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def _cost(poses: SE3, points: Tensor, prob: BAProblem,
          huber_delta: float | None = None, group=None) -> Tensor:
    """Total cost: 0.5 |r|^2 (or Huber rho) + prior terms. Under a group the
    observation and point-prior terms are summed over it; the pose prior
    (the same on every rank) is added once."""
    r, _, _ = _projection_residuals(poses, points, prob)
    rp, rx = _prior_residuals(poses, points, prob)
    if huber_delta is None:
        c_obs = 0.5 * torch.sum(r * r)
    else:
        nrm = torch.linalg.vector_norm(r, dim=-1)
        rho = torch.where(nrm <= huber_delta, 0.5 * nrm * nrm,
                          huber_delta * (nrm - 0.5 * huber_delta))
        c_obs = torch.sum(rho)
    c_point = 0.5 * torch.sum(
        rx * torch.einsum("pij,pj->pi", prob.point_prior_info, rx))
    c_pose = 0.5 * torch.sum(
        rp * torch.einsum("fij,fj->fi", prob.pose_prior_info, rp))
    return psum(c_obs + c_point, group) + c_pose


def huber_share(poses: SE3, points: Tensor, prob: BAProblem,
                huber_delta: float | None) -> Tensor:
    """The share (0-dim, in [0, 1]) of the valid observations whose
    whitened residual norm at ``poses``, ``points`` exceeds
    ``huber_delta``: those the Huber kernel down-weights there. Zero where
    ``huber_delta`` is None or no observation is valid."""
    dtype, dev = points.dtype, points.device
    if huber_delta is None:
        return torch.zeros((), dtype=dtype, device=dev)
    r, _, _ = _projection_residuals(poses, points, prob)
    robust = prob.obs_mask & (torch.linalg.vector_norm(r, dim=-1)
                              > huber_delta)
    n = torch.clamp(torch.sum(prob.obs_mask), min=1)
    return torch.sum(robust).to(dtype) / n.to(dtype)


def _normal_equations(poses: SE3, points: Tensor, prob: BAProblem,
                      huber_delta: float | None = None, group=None):
    """(Hcc (F,6,6), Hpp (P,3,3), Hcp (F,P,6,3), bc (F,6), bp (P,3)),
    ``b = -J^T r``, priors included. Under a group, Hcc and bc are summed
    over it before the pose priors are added; the landmark blocks stay
    local."""
    r, Jc, Jp = _projection_residuals(poses, points, prob, huber_delta)
    Hcc = psum(torch.einsum("fpki,fpkj->fij", Jc, Jc), group)
    Hpp = torch.einsum("fpki,fpkj->pij", Jp, Jp)
    Hcp = torch.einsum("fpki,fpkj->fpij", Jc, Jp)
    bc = psum(-torch.einsum("fpki,fpk->fi", Jc, r), group)
    bp = -torch.einsum("fpki,fpk->pi", Jp, r)
    rp, rx = _prior_residuals(poses, points, prob)
    Hcc = Hcc + prob.pose_prior_info
    Hpp = Hpp + prob.point_prior_info
    bc = bc - torch.einsum("fij,fj->fi", prob.pose_prior_info, rp)
    bp = bp - torch.einsum("pij,pj->pi", prob.point_prior_info, rx)
    return Hcc, Hpp, Hcp, bc, bp


def _schur_solve(Hcc, Hpp, Hcp, bc, bp, lam, dtype, group=None):
    """Damped Schur-complement solve -> (delta_c (F,6), delta_p (P,3),
    S_flat, Hpp_inv, W). Under a group the landmark terms of the reduced
    camera system and its right-hand side are summed over it."""
    F = Hcc.shape[0]
    dev = Hcc.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hcc_d = Hcc + lam * eye6[None]
    Hpp_inv = linalg.inv3x3(Hpp + lam * eye3[None])
    W = torch.einsum("fpij,pjk->fpik", Hcp, Hpp_inv)
    S = -psum(torch.einsum("fpik,gpjk->fgij", W, Hcp), group)
    ar = torch.arange(F, device=dev)
    S[ar, ar] = S[ar, ar] + Hcc_d
    rhs = bc - psum(torch.einsum("fpik,pk->fi", W, bp), group)
    S_flat = S.permute(0, 2, 1, 3).reshape(6 * F, 6 * F)
    rhs_flat = rhs.reshape(6 * F)
    jitter = torch.finfo(dtype).eps * (
        1.0 + torch.max(torch.abs(torch.diagonal(S_flat))))
    delta_c = linalg.solve_psd(S_flat, rhs_flat)
    # fall back to a jittered solve where the plain one goes non-finite
    bad = ~torch.all(torch.isfinite(delta_c))
    delta_j = linalg.solve_psd(
        S_flat + jitter * torch.eye(6 * F, dtype=dtype, device=dev), rhs_flat)
    delta_c = torch.where(bad, delta_j, delta_c).reshape(F, 6)
    rhs_p = bp - torch.einsum("fpij,fi->pj", Hcp, delta_c)
    delta_p = torch.einsum("pij,pj->pi", Hpp_inv, rhs_p)
    return delta_c, delta_p, S_flat, Hpp_inv, W


def _retract(poses: SE3, points: Tensor, delta_c: Tensor, delta_p: Tensor):
    return poses.compose(SE3.exp(delta_c)), points + delta_p


def ba_solve(prob: BAProblem, params: BAParams = BAParams(),
             group=None) -> BAResult:
    """LM bundle adjustment: ``max_iterations`` masked iterations, frozen
    once converged (the JAX early stop, without a host read).

    ``group``: a ``torch.distributed`` process group whose ranks each hold
    one block of the landmarks of ``prob`` and the same poses and pose
    priors (``parallel.dist_ba.distributed_ba_solve``); every rank must
    call with its block. Every rank runs the same iterations and returns
    the same poses, its own block's points."""
    dtype = prob.points0.dtype
    dev = prob.points0.device
    eps = torch.finfo(dtype).eps

    R, t, points = prob.poses0.R, prob.poses0.t, prob.points0
    lam = torch.full((), params.lambda_init, dtype=dtype, device=dev)
    cost = _cost(prob.poses0, points, prob, params.huber_delta, group)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(params.max_iterations):
        poses = SE3(R, t)
        Hcc, Hpp, Hcp, bc, bp = _normal_equations(poses, points, prob,
                                                  params.huber_delta, group)
        delta_c, delta_p, _, _, _ = _schur_solve(Hcc, Hpp, Hcp, bc, bp, lam,
                                                 dtype, group)
        new_poses, new_points = _retract(poses, points, delta_c, delta_p)
        new_cost = _cost(new_poses, new_points, prob, params.huber_delta,
                         group)
        accept = torch.isfinite(new_cost) & (new_cost < cost)
        new_lam = torch.clamp(
            torch.where(accept, lam * params.lambda_down,
                        lam * params.lambda_up),
            params.lambda_min, params.lambda_max)
        thresh = torch.maximum(
            torch.clamp(params.rel_decrease * cost, min=params.abs_decrease),
            10.0 * eps * (1.0 + cost))
        converged = torch.isfinite(new_cost) & (torch.abs(cost - new_cost)
                                                < thresh)
        converged = converged | (~accept & (new_lam >= params.lambda_max))
        take = accept & ~done
        R = torch.where(take, new_poses.R, R)
        t = torch.where(take, new_poses.t, t)
        points = torch.where(take, new_points, points)
        cost = torch.where(take, new_cost, cost)
        lam = torch.where(done, lam, new_lam)
        it = torch.where(done, it, it + 1)
        done = done | converged
    poses = SE3(R, t)

    point_info = None
    if params.compute_point_info and not params.compute_covariance:
        _, point_info, _, _, _ = _normal_equations(poses, points, prob,
                                                   group=group)

    F = prob.poses0.R.shape[0]
    P = points.shape[0]
    if params.compute_covariance:
        Hcc, Hpp, Hcp, bc, bp = _normal_equations(poses, points, prob,
                                                  params.huber_delta, group)
        if params.compute_point_info:
            point_info = Hpp
        zero = torch.zeros((), dtype=dtype, device=dev)
        _, _, S_flat, Hpp_inv, W = _schur_solve(Hcc, Hpp, Hcp, bc, bp, zero,
                                                dtype, group)
        jitter = eps * (1.0 + torch.max(torch.abs(torch.diagonal(S_flat))))
        Sigma_cc = linalg.inv_psd(
            S_flat + jitter * torch.eye(6 * F, dtype=dtype, device=dev))
        blocks = Sigma_cc.reshape(F, 6, F, 6).permute(0, 2, 1, 3)
        ar = torch.arange(F, device=dev)
        pose_cov = blocks[ar, ar]
        point_cov = Hpp_inv + torch.einsum("fpki,fgkl,gplj->pij",
                                           W, blocks, W)
    else:
        pose_cov = torch.zeros((F, 6, 6), dtype=dtype, device=dev)
        point_cov = torch.zeros((P, 3, 3), dtype=dtype, device=dev)
    return BAResult(poses=poses, points=points, pose_covariance=pose_cov,
                    point_covariance=point_cov, error=cost, iterations=it,
                    converged=done, point_information=point_info)
