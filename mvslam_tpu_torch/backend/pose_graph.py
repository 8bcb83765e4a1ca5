"""Pose-graph optimization: the functional compute core (port of
``mvslam_tpu.backend.pose_graph``).

A graph of SE3 pose nodes, SE3-with-covariance between-factor edges and
tightly anchored nodes, optimized by Levenberg-Marquardt. Fixed-capacity
node/edge tensors with validity masks; edge residuals
``ln(rel^-1 . (T_src^-1 . T_dst))`` for all edges at once; exact per-edge
Jacobians by forward-mode autodiff (``torch.func.vmap`` of
``torch.func.jacfwd`` of the residual at zero tangent); the normal
equations scatter-added into a dense 6N x 6N system solved by Cholesky.

The graph runs in the dtype of its data. The back-end builds it in
float64: a 6N x 6N Cholesky of a few hundred keyframes is small, and in
float64 the order of the scatter-adds does not show at any tolerance used.

The LM loop is a Python loop with one host read (the ``converged`` flag)
per iteration, at most ``max_iterations`` per call.

With a process ``group`` (the JAX ``axis_name``), each rank holds a block
of the edges and every node: the dense system and the edge cost are summed
over the group, then priors and pins are added once, so every rank solves
the same system and leaves the loop at the same iteration
(``parallel/dist_pose_graph.py``). The sums run outside the forward-mode
Jacobians.

The host-side ``Graph`` / ``GraphOptimizer`` wrapper lives in
``mvslam_tpu_torch.backend.graph``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvslam_tpu_torch.math import linalg
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops.ba import psum

Tensor = torch.Tensor

#: origin-anchor prior standard deviation
ORIGIN_STDDEV = 1e-4


class PoseGraphData(NamedTuple):
    """Fixed-capacity pose graph. N nodes, E edges.

    ``edge_src``/``edge_dst`` index into the node arrays; ``edge_rel`` is
    the measured ``T_dst`` in ``src`` coordinates; ``edge_info`` the 6x6
    information (inverse covariance) of that measurement. ``prior_info``
    anchors nodes (row 0 = the origin anchor).
    """

    poses: SE3               # (N,)
    node_mask: Tensor        # (N,) bool
    edge_src: Tensor         # (E,) int64
    edge_dst: Tensor         # (E,) int64
    edge_rel: SE3            # (E,)
    edge_info: Tensor        # (E, 6, 6)
    edge_mask: Tensor        # (E,) bool
    prior_pose: SE3          # (N,)
    prior_info: Tensor       # (N, 6, 6)


class PoseGraphParams(NamedTuple):
    max_iterations: int = 100
    lambda_init: float = 1e-6
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    lambda_min: float = 1e-12
    lambda_max: float = 1e10
    rel_decrease: float = 1e-12


class PoseGraphResult(NamedTuple):
    poses: SE3
    error: Tensor
    iterations: Tensor
    converged: Tensor


def _edge_residual(Ts: SE3, Td: SE3, rel: SE3) -> Tensor:
    """``ln(rel^-1 . Ts^-1 . Td)``: zero when the edge is satisfied."""
    return rel.inverse().compose(Ts.inverse().compose(Td)).log()


def _edge_poses(data: PoseGraphData) -> tuple[SE3, SE3]:
    Ts = SE3(data.poses.R[data.edge_src], data.poses.t[data.edge_src])
    Td = SE3(data.poses.R[data.edge_dst], data.poses.t[data.edge_dst])
    return Ts, Td


def _edge_residuals(data: PoseGraphData) -> Tensor:
    """All edge residuals r (E, 6), unweighted."""
    Ts, Td = _edge_poses(data)
    return _edge_residual(Ts, Td, data.edge_rel)


def _edge_residuals_and_jacobians(data: PoseGraphData):
    """All edge residuals + exact Jacobians wrt (delta_src, delta_dst).

    Right perturbation ``T <- T exp(delta)``. Returns
    r (E, 6), Js (E, 6, 6), Jd (E, 6, 6), unweighted.
    """
    Ts, Td = _edge_poses(data)

    def res(delta, Ts_R, Ts_t, Td_R, Td_t, rel_R, rel_t):
        # the tangent keeps a leading axis of one: forward-mode tangents of
        # 0-dim float32 tensors come out of Python-scalar arithmetic as
        # float64, and the next matmul then refuses the mix
        ds, dd = delta[None, :6], delta[None, 6:]
        Ts_p = SE3(Ts_R, Ts_t).compose(SE3.exp(ds))
        Td_p = SE3(Td_R, Td_t).compose(SE3.exp(dd))
        return _edge_residual(Ts_p, Td_p, SE3(rel_R, rel_t))[0]

    zero = torch.zeros(12, dtype=data.poses.t.dtype,
                       device=data.poses.t.device)
    J = torch.func.vmap(torch.func.jacfwd(res),
                        in_dims=(None, 0, 0, 0, 0, 0, 0))(
        zero, Ts.R, Ts.t, Td.R, Td.t, data.edge_rel.R, data.edge_rel.t)
    r = _edge_residual(Ts, Td, data.edge_rel)
    return r, J[..., :6], J[..., 6:]


def _prior_residuals(data: PoseGraphData) -> Tensor:
    """``ln(prior^-1 . T)`` per node, identity Jacobian approximation
    (priors live at or near their means: they fix the gauge)."""
    return data.prior_pose.inverse().compose(data.poses).log()


def pose_graph_cost(data: PoseGraphData, group=None) -> Tensor:
    """Total cost: masked edge terms (summed over ``group``) plus priors."""
    r = _edge_residuals(data)
    w = data.edge_mask.to(r.dtype)
    c_edges = 0.5 * torch.sum(
        w * torch.einsum("ei,eij,ej->e", r, data.edge_info, r))
    rp = _prior_residuals(data)
    c_prior = 0.5 * torch.sum(
        torch.einsum("ni,nij,nj->n", rp, data.prior_info, rp))
    return psum(c_edges, group) + c_prior


def _scatter_blocks(N: int, src: Tensor, dst: Tensor, Hss, Hsd, Hdd, bs, bd):
    """Dense (N, N, k, k) H and (N, k) b from per-edge blocks."""
    k = Hss.shape[-1]
    H = torch.zeros((N, N, k, k), dtype=Hss.dtype, device=Hss.device)
    H.index_put_((src, src), Hss, accumulate=True)
    H.index_put_((src, dst), Hsd, accumulate=True)
    H.index_put_((dst, src), Hsd.transpose(-1, -2), accumulate=True)
    H.index_put_((dst, dst), Hdd, accumulate=True)
    b = torch.zeros((N, k), dtype=Hss.dtype, device=Hss.device)
    b.index_put_((src,), bs, accumulate=True)
    b.index_put_((dst,), bd, accumulate=True)
    return H, b


def _add_priors_and_pins(H: Tensor, b: Tensor, prior_info: Tensor,
                         rp: Tensor, node_mask: Tensor):
    """Priors (identity Jacobian) on the diagonal blocks; masked-out nodes
    pinned with identity so the dense system stays positive definite."""
    N, k = b.shape
    ar = torch.arange(N, device=b.device)
    pin = (~node_mask).to(b.dtype)
    eye = torch.eye(k, dtype=b.dtype, device=b.device)
    H[ar, ar] = H[ar, ar] + prior_info + pin[:, None, None] * eye
    b = b - torch.einsum("nij,nj->ni", prior_info, rp)
    return H, b


def _normal_equations(data: PoseGraphData, group=None):
    """Dense (N, N, 6, 6) H and (N, 6) b by scatter-add over the edges,
    summed over ``group``, then priors and pins."""
    N = data.poses.t.shape[0]
    r, Js, Jd = _edge_residuals_and_jacobians(data)
    w = data.edge_mask.to(r.dtype)
    L = data.edge_info * w[:, None, None]           # masked info
    JsTL = torch.einsum("eki,ekl->eil", Js, L)
    JdTL = torch.einsum("eki,ekl->eil", Jd, L)
    H, b = _scatter_blocks(
        N, data.edge_src, data.edge_dst, JsTL @ Js, JsTL @ Jd, JdTL @ Jd,
        -torch.einsum("eil,el->ei", JsTL, r),
        -torch.einsum("eil,el->ei", JdTL, r))
    return _add_priors_and_pins(psum(H, group), psum(b, group),
                                data.prior_info, _prior_residuals(data),
                                data.node_mask)


def lm_optimize(poses, node_mask: Tensor, params, normal_equations, cost_fn,
                retract):
    """Levenberg-Marquardt over a dense block system, shared by the SE3 and
    Sim3 graphs: ``normal_equations(poses) -> (H (N, N, k, k), b (N, k))``,
    ``cost_fn(poses) -> ()``, ``retract(poses, delta (N, k)) -> poses``.
    Returns (poses, cost, iterations, converged); reads ``converged`` on
    the host once per iteration."""
    dev = node_mask.device
    cost = cost_fn(poses)
    dtype = cost.dtype
    eps = torch.finfo(dtype).eps
    lam = torch.full((), params.lambda_init, dtype=dtype, device=dev)
    it, done = 0, False
    while it < params.max_iterations and not done:
        H, b = normal_equations(poses)
        N, k = b.shape
        H_flat = H.permute(0, 2, 1, 3).reshape(k * N, k * N)
        eye = torch.eye(k * N, dtype=dtype, device=dev)
        delta = linalg.solve_psd(H_flat + lam * eye, b.reshape(-1))
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta)).reshape(N, k)
        delta = delta * node_mask[:, None]
        new_poses = retract(poses, delta)
        new_cost = cost_fn(new_poses)
        accept = torch.isfinite(new_cost) & (new_cost < cost)
        lam = torch.clamp(
            torch.where(accept, lam * params.lambda_down,
                        lam * params.lambda_up),
            params.lambda_min, params.lambda_max)
        poses = type(poses)(*(torch.where(accept, new, old)
                              for new, old in zip(new_poses, poses)))
        thresh = torch.maximum(params.rel_decrease * cost,
                               10.0 * eps * (1.0 + cost))
        converged = torch.isfinite(new_cost) & (
            torch.abs(cost - new_cost) < thresh)
        cost = torch.where(accept, new_cost, cost)
        it += 1
        done = bool(converged)
    return (poses, cost, torch.tensor(it, dtype=torch.int32, device=dev),
            torch.tensor(done, device=dev))


def pose_graph_optimize(
    data: PoseGraphData,
    params: PoseGraphParams = PoseGraphParams(),
    group=None,
) -> PoseGraphResult:
    """LM over the whole graph. ``group``: a ``torch.distributed`` process
    group whose ranks each hold a block of the edges and all nodes; every
    rank must call, and all return the same result."""
    poses, cost, it, done = lm_optimize(
        data.poses, data.node_mask, params,
        lambda p: _normal_equations(data._replace(poses=p), group),
        lambda p: pose_graph_cost(data._replace(poses=p), group),
        lambda p, delta: p.compose(SE3.exp(delta)))
    return PoseGraphResult(poses=poses, error=cost, iterations=it,
                           converged=done)
