"""Scale-drift-aware (Sim3) pose-graph optimization for monocular loops
(port of ``mvslam_tpu.backend.sim3_graph``).

Monocular odometry drifts in scale as well as pose. An SE3 pose graph
cannot represent that: metric loop-closure edges and scale-drifted odometry
edges are mutually inconsistent. The classic fix (Strasdat et al., "Scale
Drift-Aware Large Scale Monocular SLAM", RSS 2010) optimizes over Sim3:
each node carries (s, R, t), each edge measures the relative similarity,
and the loop's scale inconsistency distributes smoothly around the cycle.

Same shape as ``backend/pose_graph.py``: fixed-capacity tensors, all-edge
batched residuals, exact Jacobians by ``torch.func.vmap`` of
``torch.func.jacfwd`` of a 7-dof chart retraction, dense 7N x 7N normal
equations, the shared LM loop, and the same edge sharding over a process
``group``.

The residual uses the chart ``(nu, omega, lambda)`` with retraction
``T . (nu, exp(omega), e^lambda)`` and error decomposition
``E = rel^-1 . Ti^-1 . Tj -> (t_E, ln R_E, ln s_E)``: a local
diffeomorphism at identity (not the exact Sim3 Lie log; equivalent for
least squares near zero residual, and autodiff keeps the Jacobians exact
for whatever chart is chosen).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvslam_tpu_torch.backend.pose_graph import (
    _add_priors_and_pins, _scatter_blocks, lm_optimize,
)
from mvslam_tpu_torch.math.lie import _matvec, so3_exp, so3_log
from mvslam_tpu_torch.ops.ba import psum

Tensor = torch.Tensor


class Sim3(NamedTuple):
    """Similarity transform ``x -> s R x + t`` (batched leaves allowed)."""

    s: Tensor                # (...,)
    R: Tensor                # (..., 3, 3)
    t: Tensor                # (..., 3)

    @staticmethod
    def identity(shape=(), dtype=torch.float32, device=None) -> "Sim3":
        return Sim3(
            torch.ones(shape, dtype=dtype, device=device),
            torch.eye(3, dtype=dtype, device=device).expand(
                tuple(shape) + (3, 3)).clone(),
            torch.zeros(tuple(shape) + (3,), dtype=dtype, device=device))

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(self.s * other.s, self.R @ other.R,
                    self.s[..., None] * _matvec(self.R, other.t) + self.t)

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        inv_s = 1.0 / self.s
        return Sim3(inv_s, Rt, -inv_s[..., None] * _matvec(Rt, self.t))

    def apply(self, x: Tensor) -> Tensor:
        return self.s[..., None] * _matvec(self.R, x) + self.t

    def retract(self, delta: Tensor) -> "Sim3":
        """Right-chart update: ``T . (nu, exp(omega), e^lambda)`` with
        ``delta = (nu[3], omega[3], lambda[1])``."""
        nu = delta[..., :3]
        omega = delta[..., 3:6]
        lam = delta[..., 6]
        return self.compose(Sim3(torch.exp(lam), so3_exp(omega), nu))

    def chart_log(self) -> Tensor:
        """(t, ln R, ln s): the 7-dof error chart (identity iff self is)."""
        return torch.cat(
            [self.t, so3_log(self.R), torch.log(self.s)[..., None]], dim=-1)


class Sim3GraphData(NamedTuple):
    """Fixed-capacity Sim3 pose graph (N nodes, E edges). ``edge_rel`` is
    the measured similarity of dst in src coordinates (scale 1 for
    odometry, the measured ratio for loop resections); ``prior_info``
    anchors nodes."""

    poses: Sim3              # (N,)
    node_mask: Tensor        # (N,) bool
    edge_src: Tensor         # (E,) int64
    edge_dst: Tensor         # (E,) int64
    edge_rel: Sim3           # (E,)
    edge_info: Tensor        # (E, 7, 7)
    edge_mask: Tensor        # (E,) bool
    prior_pose: Sim3         # (N,)
    prior_info: Tensor       # (N, 7, 7)


class Sim3GraphParams(NamedTuple):
    max_iterations: int = 100
    lambda_init: float = 1e-6
    lambda_up: float = 10.0
    lambda_down: float = 0.1
    lambda_min: float = 1e-12
    lambda_max: float = 1e10
    rel_decrease: float = 1e-12
    # Huber threshold on the whitened per-edge residual norm (sigmas).
    # Loop-closure graphs carry occasional bad edges (wide-baseline
    # measurements whose error model is optimistic); IRLS-downweighting
    # them is the standard robust pose-graph move. None = pure Gaussian.
    huber_delta: float | None = 3.0


class Sim3GraphResult(NamedTuple):
    poses: Sim3
    error: Tensor
    iterations: Tensor
    converged: Tensor


def _gather(x: Sim3, i: Tensor) -> Sim3:
    return Sim3(x.s[i], x.R[i], x.t[i])


def _edge_error(Ts: Sim3, Td: Sim3, rel: Sim3) -> Tensor:
    return rel.inverse().compose(Ts.inverse().compose(Td)).chart_log()


def _edge_residuals(data: Sim3GraphData) -> Tensor:
    """All-edge residuals r (E, 7)."""
    return _edge_error(_gather(data.poses, data.edge_src),
                       _gather(data.poses, data.edge_dst), data.edge_rel)


def _edge_residuals_and_jacobians(data: Sim3GraphData):
    """All-edge residuals + exact chart Jacobians wrt (delta_src, delta_dst):
    r (E, 7), Js (E, 7, 7), Jd (E, 7, 7)."""
    Ts = _gather(data.poses, data.edge_src)
    Td = _gather(data.poses, data.edge_dst)

    def res(delta, Ts, Td, rel):
        # leading axis of one on the tangent: see pose_graph.py
        return _edge_error(Ts.retract(delta[None, :7]),
                           Td.retract(delta[None, 7:]), rel)[0]

    zero = torch.zeros(14, dtype=data.poses.t.dtype,
                       device=data.poses.t.device)
    J = torch.func.vmap(torch.func.jacfwd(res), in_dims=(None, 0, 0, 0))(
        zero, Ts, Td, data.edge_rel)
    return _edge_error(Ts, Td, data.edge_rel), J[..., :7], J[..., 7:]


def _prior_residuals(data: Sim3GraphData) -> Tensor:
    return data.prior_pose.inverse().compose(data.poses).chart_log()


def _huber_rho_and_weight(e2: Tensor, delta: float | None):
    """Huber rho(e) and IRLS weight for squared whitened norms ``e2``."""
    if delta is None:
        return e2, torch.ones_like(e2)
    e = torch.sqrt(torch.clamp(e2, min=1e-30))
    w = torch.clamp(delta / e, max=1.0)
    rho = torch.where(e <= delta, e2, 2.0 * delta * e - delta * delta)
    return rho, w


def sim3_graph_cost(data: Sim3GraphData,
                    huber_delta: float | None = None, group=None) -> Tensor:
    r = _edge_residuals(data)
    w = data.edge_mask.to(r.dtype)
    e2 = torch.einsum("ei,eij,ej->e", r, data.edge_info, r)
    rho, _ = _huber_rho_and_weight(e2, huber_delta)
    c_edges = 0.5 * torch.sum(w * rho)
    rp = _prior_residuals(data)
    c_prior = 0.5 * torch.sum(
        torch.einsum("ni,nij,nj->n", rp, data.prior_info, rp))
    return psum(c_edges, group) + c_prior


def _normal_equations(data: Sim3GraphData, huber_delta: float | None = None,
                      group=None):
    N = data.poses.t.shape[0]
    r, Js, Jd = _edge_residuals_and_jacobians(data)
    e2 = torch.einsum("ei,eij,ej->e", r, data.edge_info, r)
    _, w_h = _huber_rho_and_weight(e2, huber_delta)
    w = data.edge_mask.to(r.dtype) * w_h
    L = data.edge_info * w[:, None, None]
    JsTL = torch.einsum("eki,ekl->eil", Js, L)
    JdTL = torch.einsum("eki,ekl->eil", Jd, L)
    H, b = _scatter_blocks(
        N, data.edge_src, data.edge_dst, JsTL @ Js, JsTL @ Jd, JdTL @ Jd,
        -torch.einsum("eil,el->ei", JsTL, r),
        -torch.einsum("eil,el->ei", JdTL, r))
    return _add_priors_and_pins(psum(H, group), psum(b, group),
                                data.prior_info, _prior_residuals(data),
                                data.node_mask)


def sim3_graph_optimize(
    data: Sim3GraphData,
    params: Sim3GraphParams = Sim3GraphParams(),
    group=None,
) -> Sim3GraphResult:
    """LM over Sim3 nodes; ``group`` as in
    :func:`mvslam_tpu_torch.backend.pose_graph.pose_graph_optimize`."""
    hd = params.huber_delta
    poses, cost, it, done = lm_optimize(
        data.poses, data.node_mask, params,
        lambda p: _normal_equations(data._replace(poses=p), hd, group),
        lambda p: sim3_graph_cost(data._replace(poses=p), hd, group),
        Sim3.retract)
    return Sim3GraphResult(poses=poses, error=cost, iterations=it,
                           converged=done)
