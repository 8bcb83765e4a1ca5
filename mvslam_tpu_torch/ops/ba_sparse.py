"""Sparse (fixed-degree) bundle adjustment for large maps (port of
``mvslam_tpu.ops.ba_sparse``).

The dense :mod:`mvslam_tpu_torch.ops.ba` materializes an (F, P) observation
grid and a dense 6F x 6F reduced camera system: right for the two-frame
tracking BA, unrepresentable for long keyframe sequences. Here:

- **Fixed-degree observation lists**: each landmark stores up to D
  observations ``(obs_frame (P, D), obs (P, D, 2), mask, weight)``; storage
  is O(P*D), independent of F.
- **Gather / scatter-add normal equations**: per-observation 2x6 / 2x3
  Jacobian blocks are built by gathering poses per observation;
  frame-indexed reductions are ``index_add_``.
- **Matrix-free PCG camera solve**: the reduced camera system
  ``S = Hcc - W Hpp^-1 W^T`` is never materialized; CG applies ``S x``
  through the same gather/scatter pipeline with block-Jacobi (6x6)
  preconditioning. The CG runs a fixed number of iterations, frozen by
  masks once the residual is below tolerance, with no host read inside.

The LM loop is a Python loop that reads the ``converged`` flag once per
iteration (the JAX ``while_loop`` condition).

With a process ``group`` (the JAX ``axis_name``), each rank holds a
contiguous block of the landmarks (a time block of the sequence) and the
same poses; the camera blocks, the reduced right-hand side, every CG
application of the reduced system and the cost's landmark terms are
summed over the group (``parallel/dist_ba_sparse.py``). The ``converged``
flag is computed from summed values only, so every rank leaves the loop at
the same iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvslam_tpu_torch.math import linalg
from mvslam_tpu_torch.math.lie import SE3, skew
from mvslam_tpu_torch.ops import ba as ba_mod
from mvslam_tpu_torch.ops.ba import psum

Tensor = torch.Tensor


class SparseBAProblem(NamedTuple):
    """F frames, P landmarks, degree-D observation lists per landmark."""

    poses0: SE3                 # (F,) camera-to-world
    points0: Tensor             # (P, 3)
    obs_frame: Tensor           # (P, D) int64 frame index of each observation
    obs: Tensor                 # (P, D, 2) ideal-plane measurements
    obs_mask: Tensor            # (P, D) bool
    obs_weight: Tensor          # (P, D) 1/sigma
    pose_prior: SE3             # (F,)
    pose_prior_info: Tensor     # (F, 6, 6)
    point_prior: Tensor         # (P, 3)
    point_prior_info: Tensor    # (P, 3, 3)

    @staticmethod
    def create(poses0: SE3, points0: Tensor, obs_frame: Tensor, obs: Tensor,
               obs_mask: Tensor, obs_weight: Tensor | None = None,
               pose_prior: SE3 | None = None,
               pose_prior_info: Tensor | None = None,
               point_prior: Tensor | None = None,
               point_prior_info: Tensor | None = None) -> "SparseBAProblem":
        dtype, dev = points0.dtype, points0.device
        F = poses0.t.shape[0]
        P, D = obs_frame.shape
        if obs_weight is None:
            obs_weight = torch.ones((P, D), dtype=dtype, device=dev)
        if pose_prior is None:
            pose_prior = SE3.identity((F,), dtype=dtype, device=dev)
        if pose_prior_info is None:
            pose_prior_info = torch.zeros((F, 6, 6), dtype=dtype, device=dev)
        if point_prior is None:
            point_prior = torch.zeros((P, 3), dtype=dtype, device=dev)
        if point_prior_info is None:
            point_prior_info = torch.zeros((P, 3, 3), dtype=dtype, device=dev)
        return SparseBAProblem(
            poses0, points0, obs_frame.to(torch.int64), obs,
            obs_mask.to(torch.bool), obs_weight, pose_prior, pose_prior_info,
            point_prior, point_prior_info)

    @property
    def num_frames(self) -> int:
        return self.poses0.t.shape[0]


class SparseBAParams(NamedTuple):
    max_iterations: int = 30
    cg_iterations: int = 40
    cg_tol: float = 1e-6        # relative residual; freezes converged systems
    lambda_init: float = 1e-4
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    lambda_min: float = 1e-12
    lambda_max: float = 1e8
    rel_decrease: float = 1e-8


class SparseBAResult(NamedTuple):
    poses: SE3
    points: Tensor
    error: Tensor
    iterations: Tensor
    converged: Tensor


def _residuals(poses: SE3, points: Tensor, prob: SparseBAProblem):
    """Weighted residuals and Jacobians per observation: r (P, D, 2),
    Jc (P, D, 2, 6), Jp (P, D, 2, 3), pre-masked and pre-weighted. Pose data
    is gathered per observation instead of an (F, P) cross product."""
    f = prob.obs_frame
    R = poses.R[f]                                      # (P, D, 3, 3)
    t = poses.t[f]                                      # (P, D, 3)
    diff = points[:, None, :] - t
    Xc = torch.einsum("pdji,pdj->pdi", R, diff)
    z = Xc[..., 2]
    eps = torch.finfo(points.dtype).eps
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
    )                                                   # (P, D, 2, 3)
    # dX_c/d delta with T <- T exp([u, w]):  du -> -I, dw -> skew(X_c)
    Jc = torch.cat([-dproj, dproj @ skew(Xc)], dim=-1)
    Jp = torch.einsum("pdij,pdkj->pdik", dproj, R)
    Jc = Jc * w[..., None, None]
    Jp = Jp * w[..., None, None]
    return r, Jc, Jp


def _cost(poses: SE3, points: Tensor, prob: SparseBAProblem,
          group=None) -> Tensor:
    r, _, _ = _residuals(poses, points, prob)
    rx = points - prob.point_prior
    rp = prob.pose_prior.inverse().compose(poses).log()
    c_local = 0.5 * torch.sum(r * r) + 0.5 * torch.sum(
        rx * torch.einsum("pij,pj->pi", prob.point_prior_info, rx))
    c_pose = 0.5 * torch.sum(
        rp * torch.einsum("fij,fj->fi", prob.pose_prior_info, rp))
    return psum(c_local, group) + c_pose


def _segment6(x: Tensor, seg: Tensor, F: int) -> Tensor:
    """Sum of (N, ...) rows into (F, ...) by frame index."""
    out = torch.zeros((F,) + x.shape[1:], dtype=x.dtype, device=x.device)
    return out.index_add_(0, seg, x)


class _Assembled(NamedTuple):
    Hcc: Tensor         # (F, 6, 6) block-diagonal camera Hessian (+prior)
    Hpp_inv: Tensor     # (P, 3, 3) damped inverted landmark blocks
    A: Tensor           # (P, D, 6, 3) Jc^T Jp coupling blocks
    bc: Tensor          # (F, 6)
    bp: Tensor          # (P, 3)
    seg: Tensor         # (P*D,) flattened frame indices


def _assemble(poses: SE3, points: Tensor, prob: SparseBAProblem,
              lam, group=None) -> _Assembled:
    dtype, dev = points.dtype, points.device
    F = prob.num_frames
    P, D = prob.obs_frame.shape
    r, Jc, Jp = _residuals(poses, points, prob)
    seg = prob.obs_frame.reshape(P * D)
    # camera blocks: scatter-add per observation into the (F, 6, 6) diagonal
    HccO = torch.einsum("pdki,pdkj->pdij", Jc, Jc).reshape(P * D, 6, 6)
    Hcc = psum(_segment6(HccO, seg, F), group) + prob.pose_prior_info
    bcO = -torch.einsum("pdki,pdk->pdi", Jc, r).reshape(P * D, 6)
    rp = prob.pose_prior.inverse().compose(poses).log()
    bc = psum(_segment6(bcO, seg, F), group) - torch.einsum(
        "fij,fj->fi", prob.pose_prior_info, rp)
    # landmark blocks
    Hpp = torch.einsum("pdki,pdkj->pij", Jp, Jp) + prob.point_prior_info
    rx = points - prob.point_prior
    bp = -torch.einsum("pdki,pdk->pi", Jp, r) - torch.einsum(
        "pij,pj->pi", prob.point_prior_info, rx)
    Hpp_inv = linalg.inv3x3(Hpp + lam * torch.eye(3, dtype=dtype, device=dev))
    A = torch.einsum("pdki,pdkj->pdij", Jc, Jp)         # (P, D, 6, 3)
    Hcc_d = Hcc + lam * torch.eye(6, dtype=dtype, device=dev)
    return _Assembled(Hcc_d, Hpp_inv, A, bc, bp, seg)


def _schur_matvec(asm: _Assembled, x: Tensor, F: int, group=None) -> Tensor:
    """Apply the reduced camera system ``S x`` without materializing S:
    ``S x = Hcc_d x - sum_p A_p Hpp_inv_p A_p^T x`` where ``A_p^T x``
    gathers x rows by each observation's frame and the outer product
    scatters back. One sum over the group per application."""
    P, D = asm.A.shape[:2]
    xg = x[asm.seg.reshape(P, D)]                        # (P, D, 6)
    y = torch.einsum("pdij,pdi->pj", asm.A, xg)          # (P, 3)
    z = torch.einsum("pij,pj->pi", asm.Hpp_inv, y)       # (P, 3)
    wback = torch.einsum("pdij,pj->pdi", asm.A, z)       # (P, D, 6)
    coupling = psum(_segment6(wback.reshape(P * D, 6), asm.seg, F), group)
    return torch.einsum("fij,fj->fi", asm.Hcc, x) - coupling


def _pcg(asm: _Assembled, rhs: Tensor, F: int,
         params: SparseBAParams, group=None) -> Tensor:
    """Block-Jacobi preconditioned CG on the reduced camera system: a fixed
    iteration count; iterations past convergence are frozen with a
    where-mask on the relative residual."""
    dtype, dev = rhs.dtype, rhs.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    jitter = torch.finfo(dtype).eps * (1.0 + torch.max(torch.abs(asm.Hcc)))
    Minv = linalg.inv_psd(asm.Hcc + jitter * eye6[None])  # (F, 6, 6)

    def precond(v):
        return torch.einsum("fij,fj->fi", Minv, v)

    zero = torch.zeros((), dtype=dtype, device=dev)
    x = torch.zeros_like(rhs)
    r = rhs                                # S x0 = 0
    zv = precond(r)
    p = zv
    rz = torch.sum(r * zv)
    r0 = torch.sqrt(torch.sum(rhs * rhs))
    tol2 = (params.cg_tol * r0) ** 2
    for _ in range(params.cg_iterations):
        live = torch.sum(r * r) > tol2
        Sp = _schur_matvec(asm, p, F, group)
        denom = torch.sum(p * Sp)
        alpha = torch.where(torch.abs(denom) > 0, rz / denom, zero)
        alpha = torch.where(live & torch.isfinite(alpha), alpha, zero)
        x = x + alpha * p
        r_new = r - alpha * Sp
        z_new = precond(r_new)
        rz_new = torch.sum(r_new * z_new)
        beta = torch.where(rz > 0, rz_new / rz, zero)
        beta = torch.where(live & torch.isfinite(beta), beta, zero)
        p = torch.where(live, z_new + beta * p, p)
        r = torch.where(live, r_new, r)
        rz = torch.where(live, rz_new, rz)
    return x


def sparse_ba_solve(prob: SparseBAProblem,
                    params: SparseBAParams = SparseBAParams(),
                    group=None) -> SparseBAResult:
    """LM with inexact (PCG) Schur steps over fixed-degree observations.
    One host read per LM iteration (the ``converged`` flag).

    ``group``: a ``torch.distributed`` process group whose ranks each hold
    one block of the landmarks of ``prob`` and the same poses and pose
    priors; every rank must call with its block, and all return the same
    poses, cost and iteration count, each its own block's points."""
    dtype, dev = prob.points0.dtype, prob.points0.device
    F = prob.num_frames
    P, D = prob.obs_frame.shape
    eps = torch.finfo(dtype).eps

    R, t, points = prob.poses0.R, prob.poses0.t, prob.points0
    lam = torch.full((), params.lambda_init, dtype=dtype, device=dev)
    cost = _cost(prob.poses0, points, prob, group)
    it, done = 0, False
    while it < params.max_iterations and not done:
        poses = SE3(R, t)
        asm = _assemble(poses, points, prob, lam, group)
        # reduced (Schur) RHS: bc - W Hpp^-1 bp, scattered by frame
        yb = torch.einsum("pij,pj->pi", asm.Hpp_inv, asm.bp)     # (P, 3)
        red = torch.einsum("pdij,pj->pdi", asm.A, yb)            # (P, D, 6)
        rhs = asm.bc - psum(_segment6(red.reshape(P * D, 6), asm.seg, F),
                            group)
        delta_c = _pcg(asm, rhs, F, params, group)
        # landmark back-substitution
        xg = delta_c[asm.seg.reshape(P, D)]
        rhs_p = asm.bp - torch.einsum("pdij,pdi->pj", asm.A, xg)
        delta_p = torch.einsum("pij,pj->pi", asm.Hpp_inv, rhs_p)
        new_poses = poses.compose(SE3.exp(delta_c))
        new_points = points + delta_p
        new_cost = _cost(new_poses, new_points, prob, group)
        accept = torch.isfinite(new_cost) & (new_cost < cost)
        lam = torch.clamp(
            torch.where(accept, lam * params.lambda_down,
                        lam * params.lambda_up),
            params.lambda_min, params.lambda_max)
        R = torch.where(accept, new_poses.R, R)
        t = torch.where(accept, new_poses.t, t)
        points = torch.where(accept, new_points, points)
        thresh = torch.maximum(params.rel_decrease * cost,
                               10.0 * eps * (1.0 + cost))
        converged = torch.isfinite(new_cost) & (
            torch.abs(cost - new_cost) < thresh)
        converged = converged | (~accept & (lam >= params.lambda_max))
        cost = torch.where(accept, new_cost, cost)
        it += 1
        done = bool(converged)
    return SparseBAResult(
        poses=SE3(R, t), points=points, error=cost,
        iterations=torch.tensor(it, dtype=torch.int32, device=dev),
        converged=torch.tensor(done, device=dev))


def densify(prob: SparseBAProblem) -> ba_mod.BAProblem:
    """Convert to a dense :class:`mvslam_tpu_torch.ops.ba.BAProblem`
    (testing oracle only: O(F*P) memory)."""
    F = prob.num_frames
    P, D = prob.obs_frame.shape
    dtype, dev = prob.points0.dtype, prob.points0.device
    obs = torch.zeros((F, P, 2), dtype=dtype, device=dev)
    mask = torch.zeros((F, P), dtype=torch.bool, device=dev)
    weight = torch.ones((F, P), dtype=dtype, device=dev)
    keep = prob.obs_mask                                 # drop masked
    f = prob.obs_frame[keep]
    pidx = torch.arange(P, device=dev)[:, None].expand(P, D)[keep]
    obs[f, pidx] = prob.obs[keep]
    mask[f, pidx] = True
    weight[f, pidx] = prob.obs_weight[keep]
    return ba_mod.BAProblem.create(
        poses0=prob.poses0, points0=prob.points0,
        obs=obs, obs_mask=mask, obs_weight=weight,
        pose_prior=prob.pose_prior, pose_prior_info=prob.pose_prior_info,
        point_prior=prob.point_prior,
        point_prior_info=prob.point_prior_info)
