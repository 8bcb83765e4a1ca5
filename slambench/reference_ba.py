"""A plain two-frame bundle adjustment with the Huber kernel: the reference
that the port's BA (``mvslam_tpu_torch/ops/ba.py``, ``ba_solve``) is held
to on the KITTI deployment's problems. It imports neither JAX nor the
port, and computes in float64 with TF32 off.

The problem is the port's: F camera-to-world poses (R, t), P points,
observations ``obs`` (F, P, 2) on the normalised image plane with a mask
and a weight 1/sigma each, a prior on each pose (information ``(F, 6,
6)`` on the tangent ``log(prior^-1 T)``, translation first) and on each
point (information ``(P, 3, 3)``). A point ``X`` seen from pose (R, t) is
``Xc = R^T (X - t)``, projected to ``Xc[:2] / Xc[2]``; the whitened
residual is ``(projection - obs) * weight``, zero where the mask is
false. The cost is the sum over observations of ``rho(|r|)`` (``0.5
|r|^2``, or with ``huber_delta`` Huber's ``0.5 |r|^2`` up to the delta and
``delta (|r| - delta / 2)`` above it) plus ``0.5 e^T info e`` for each
prior's error ``e``.

The solver is Levenberg-Marquardt with the port's schedule (a step is
taken where it lowers the cost; the damping ``lam`` multiplied by 0.1
after a step taken and by 10 after one refused, within [1e-12, 1e8]; a
stop once the cost moves by less than ``max(rel_decrease * cost, 10 eps
(1 + cost))``, or once a refused step meets the largest damping). Its
departures from the port's solver:

- float64 throughout, where the port computes in its problem's dtype
  (float32 on the card);
- one dense system over all 6F + 3P unknowns, damped by ``lam I`` and
  solved by LU: no Schur complement of the points, no jittered fallback;
- the Jacobians by forward-mode automatic differentiation of the
  residuals, where the port writes them out;
- the pose priors' Jacobian exact (the derivative of ``log(prior^-1 T
  exp(d))``), where the port takes the identity;
- Huber by iteratively reweighted least squares: each iteration's system
  weighs an observation by ``min(1, delta / |r|)`` at the iteration's
  start, as the port does;
- the rotation's logarithm accurate away from a half turn only (the
  priors' errors here are small).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

Tensor = torch.Tensor
F64 = torch.float64
#: below this angle (rad) the exponential and the logarithm use their
#: Taylor series
SMALL = 1e-4


class Problem(NamedTuple):
    """A two-frame (or F-frame) BA problem, float64 on any device."""

    R: Tensor                   # (F, 3, 3) camera-to-world
    t: Tensor                   # (F, 3)
    points: Tensor              # (P, 3)
    obs: Tensor                 # (F, P, 2)
    obs_mask: Tensor            # (F, P) bool
    obs_weight: Tensor          # (F, P) 1/sigma
    prior_R: Tensor             # (F, 3, 3)
    prior_t: Tensor             # (F, 3)
    prior_info: Tensor          # (F, 6, 6)
    point_prior: Tensor         # (P, 3)
    point_prior_info: Tensor    # (P, 3, 3)


class Result(NamedTuple):
    R: Tensor
    t: Tensor
    points: Tensor
    cost: Tensor
    iterations: int


def from_port(prob, device=None) -> Problem:
    """The problem of a port's ``BAProblem`` (read by its field names), in
    float64 on ``device`` (its own when None)."""
    def c(x):
        x = x.detach()
        x = x.to(device) if device is not None else x
        return x if x.dtype == torch.bool else x.to(F64)

    return Problem(c(prob.poses0.R), c(prob.poses0.t), c(prob.points0),
                   c(prob.obs), c(prob.obs_mask), c(prob.obs_weight),
                   c(prob.pose_prior.R), c(prob.pose_prior.t),
                   c(prob.pose_prior_info), c(prob.point_prior),
                   c(prob.point_prior_info))


def _skew(w: Tensor) -> Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coeffs(th2: Tensor):
    """sin(th)/th, (1 - cos th)/th^2, (th - sin th)/th^3, by series below
    ``SMALL``; the other branch is fed a safe angle."""
    small = th2 < SMALL * SMALL
    s2 = torch.where(small, torch.ones_like(th2), th2)
    s = torch.sqrt(s2)
    a = torch.where(small, 1 - th2 / 6, torch.sin(s) / s)
    b = torch.where(small, 0.5 - th2 / 24, (1 - torch.cos(s)) / s2)
    c = torch.where(small, 1 / 6 - th2 / 120, (s - torch.sin(s)) / (s2 * s))
    return a, b, c


def se3_exp(xi: Tensor):
    """(R, t) of the tangent ``[u, w]`` (translation first)."""
    u, w = xi[..., :3], xi[..., 3:]
    a, b, c = _coeffs(torch.sum(w * w, -1))
    K = _skew(w)
    K2 = K @ K
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a[..., None, None] * K + b[..., None, None] * K2
    V = eye + b[..., None, None] * K + c[..., None, None] * K2
    return R, (V @ u[..., None])[..., 0]


def se3_log(R: Tensor, t: Tensor) -> Tensor:
    """The tangent ``[u, w]`` of (R, t)."""
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    cos = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2,
                      -1.0, 1.0)
    sin_vee = 0.5 * torch.linalg.vector_norm(vee, dim=-1)
    th = torch.atan2(sin_vee, cos)
    small = th < SMALL
    safe = torch.where(small, torch.ones_like(th), th)
    scale = torch.where(small, 0.5 + th * th / 12,
                        safe / (2 * torch.sin(safe)))
    w = scale[..., None] * vee
    th2 = torch.sum(w * w, -1)
    a, b, _ = _coeffs(th2)
    s2 = torch.where(th2 < SMALL * SMALL, torch.ones_like(th2), th2)
    g = torch.where(th2 < SMALL * SMALL, 1 / 12 + th2 / 720,
                    (1 - 0.5 * a / b) / s2)
    K = _skew(w)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    V_inv = eye - 0.5 * K + g[..., None, None] * (K @ K)
    return torch.cat([(V_inv @ t[..., None])[..., 0], w], -1)


def _retract(R, t, d):
    """(R, t) composed on the right with exp(d)."""
    dR, dt = se3_exp(d)
    return R @ dR, (R @ dt[..., None])[..., 0] + t


def _projection(R, t, X, obs, weight, eps):
    """The whitened residual (2,) of one observation."""
    Xc = R.transpose(-1, -2) @ (X - t)
    z = Xc[2]
    z = torch.where(torch.abs(z) < 1e3 * eps, torch.full_like(z, 1e3 * eps),
                    z)
    return (Xc[:2] / z - obs) * weight


def _residuals(prob: Problem, R, t, X, eps):
    """Whitened projection residuals (F, P, 2), zero where masked."""
    F, P = prob.obs_mask.shape
    w = torch.where(prob.obs_mask, prob.obs_weight,
                    torch.zeros_like(prob.obs_weight))
    f = vmap(vmap(_projection, in_dims=(None, None, 0, 0, 0, None)),
             in_dims=(0, 0, None, 0, 0, None))
    return f(R, t, X, prob.obs, w, eps)


def _rho(r: Tensor, huber_delta):
    n = torch.linalg.vector_norm(r, dim=-1)
    if huber_delta is None:
        return 0.5 * n * n
    return torch.where(n <= huber_delta, 0.5 * n * n,
                       huber_delta * (n - 0.5 * huber_delta))


def cost(prob: Problem, R, t, X, huber_delta=None, eps=None) -> Tensor:
    eps = torch.finfo(F64).eps if eps is None else eps
    r = _residuals(prob, R, t, X, eps)
    e_pose = se3_log(*_compose_inv(prob.prior_R, prob.prior_t, R, t))
    e_pt = X - prob.point_prior
    return (torch.sum(_rho(r, huber_delta))
            + 0.5 * torch.einsum("fi,fij,fj->", e_pose, prob.prior_info,
                                 e_pose)
            + 0.5 * torch.einsum("pi,pij,pj->", e_pt, prob.point_prior_info,
                                 e_pt))


def _compose_inv(PR, Pt, R, t):
    """prior^-1 . T."""
    PRt = PR.transpose(-1, -2)
    return PRt @ R, (PRt @ (t - Pt)[..., None])[..., 0]


def _system(prob: Problem, R, t, X, huber_delta, eps):
    """The dense normal equations (H, g) over the unknowns [d_0 .. d_F-1,
    dX_0 .. dX_P-1] at (R, t, X): ``H = J^T J``, ``g = J^T r`` with the
    IRLS weights and the priors."""
    F, P = prob.obs_mask.shape
    n = 6 * F + 3 * P
    w = torch.where(prob.obs_mask, prob.obs_weight,
                    torch.zeros_like(prob.obs_weight))

    def one(Rf, tf, Xp, o, wt):
        def r(z):
            Rn, tn = _retract(Rf, tf, z[:6])
            return _projection(Rn, tn, Xp + z[6:], o, wt, eps)
        zero = torch.zeros(9, dtype=F64, device=Xp.device)
        return r(zero), jacfwd(r)(zero)

    f = vmap(vmap(one, in_dims=(None, None, 0, 0, 0)),
             in_dims=(0, 0, None, 0, 0))
    r, J = f(R, t, X, prob.obs, w)                 # (F,P,2), (F,P,2,9)
    if huber_delta is not None:
        nrm = torch.linalg.vector_norm(r, dim=-1)
        s = torch.sqrt(torch.clamp(
            huber_delta / torch.clamp(nrm, min=torch.finfo(F64).tiny),
            max=1.0))
        r = r * s[..., None]
        J = J * s[..., None, None]
    rows = 2 * F * P
    Jd = torch.zeros((rows, n), dtype=F64, device=X.device)
    fi = torch.arange(F, device=X.device)[:, None].expand(F, P)
    pi = torch.arange(P, device=X.device)[None, :].expand(F, P)
    row = (2 * (fi * P + pi))[..., None] + torch.arange(2, device=X.device)
    cols_c = (6 * fi)[..., None] + torch.arange(6, device=X.device)
    cols_p = (6 * F + 3 * pi)[..., None] + torch.arange(3, device=X.device)
    Jd[row[..., :, None], cols_c[..., None, :]] = J[..., :6]
    Jd[row[..., :, None], cols_p[..., None, :]] = J[..., 6:]
    rv = r.reshape(rows)
    H = Jd.T @ Jd
    g = Jd.T @ rv

    # the pose priors, with the exact derivative of their error
    def e_pose(z, Rf, tf, PR, Pt):
        Rn, tn = _retract(Rf, tf, z)
        return se3_log(*_compose_inv(PR, Pt, Rn, tn))
    zero6 = torch.zeros(6, dtype=F64, device=X.device)
    for k in range(F):
        args = (R[k], t[k], prob.prior_R[k], prob.prior_t[k])
        e = e_pose(zero6, *args)
        Je = jacfwd(e_pose)(zero6, *args)
        sl = slice(6 * k, 6 * k + 6)
        H[sl, sl] += Je.T @ prob.prior_info[k] @ Je
        g[sl] += Je.T @ (prob.prior_info[k] @ e)
    e_pt = X - prob.point_prior
    for a in range(3):
        for b in range(3):
            ia = 6 * F + 3 * torch.arange(P, device=X.device) + a
            ib = 6 * F + 3 * torch.arange(P, device=X.device) + b
            H[ia, ib] += prob.point_prior_info[:, a, b]
    g[6 * F:] += torch.einsum("pij,pj->pi", prob.point_prior_info,
                              e_pt).reshape(-1)
    return H, g


def solve(prob: Problem, huber_delta: float | None = None,
          max_iterations: int = 50, lambda_init: float = 1e-4,
          lambda_up: float = 10.0, lambda_down: float = 0.1,
          lambda_min: float = 1e-12, lambda_max: float = 1e8,
          rel_decrease: float = 1e-8, abs_decrease: float = 0.0) -> Result:
    """Levenberg-Marquardt on ``prob`` in float64 from its initial poses
    and points."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = torch.finfo(F64).eps
    F, P = prob.obs_mask.shape
    R, t, X = prob.R, prob.t, prob.points
    c = cost(prob, R, t, X, huber_delta, eps)
    lam = lambda_init
    eye = torch.eye(6 * F + 3 * P, dtype=F64, device=X.device)
    it = 0
    for _ in range(max_iterations):
        H, g = _system(prob, R, t, X, huber_delta, eps)
        d = torch.linalg.solve(H + lam * eye, -g)
        Rn, tn = _retract(R, t, d[:6 * F].reshape(F, 6))
        Xn = X + d[6 * F:].reshape(P, 3)
        cn = cost(prob, Rn, tn, Xn, huber_delta, eps)
        finite = bool(torch.isfinite(cn))
        accept = finite and bool(cn < c)
        lam = min(max(lam * (lambda_down if accept else lambda_up),
                      lambda_min), lambda_max)
        thresh = max(max(rel_decrease * float(c), abs_decrease),
                     10 * eps * (1 + float(c)))
        done = (finite and abs(float(c) - float(cn)) < thresh) or (
            not accept and lam >= lambda_max)
        if accept:
            R, t, X, c = Rn, tn, Xn, cn
        it += 1
        if done:
            break
    return Result(R, t, X, c, it)


class Gaps(NamedTuple):
    """How far a solve lies from the reference's: the largest rotation
    angle between their poses (rad); the largest pose centre gap over the
    baseline (the distance between the reference's first and last
    centres); over the points with a valid observation, the largest point
    gap in the reference's sigmas, ``sqrt(dX^T info dX)`` with the point's
    block of the reference's normal equations at its result, and the
    largest over the point's depth in the reference's last camera; and
    the solve's cost over the reference's, less 1, both in float64 under
    the reference's kernel."""

    rot: float
    trans: float
    point: float
    point_rel: float
    cost: float


def robust_share(prob: Problem, R, t, X, huber_delta: float | None) -> float:
    """The share of the valid observations whose whitened residual norm at
    (R, t, X) exceeds ``huber_delta``; 0 without a delta or a valid
    observation."""
    n = int(prob.obs_mask.sum())
    if huber_delta is None or n == 0:
        return 0.0
    r = _residuals(prob, R, t, X, torch.finfo(F64).eps)
    over = prob.obs_mask & (torch.linalg.vector_norm(r, dim=-1)
                            > huber_delta)
    return int(over.sum()) / n


def point_information(prob: Problem, ref: Result,
                      huber_delta: float | None = None) -> Tensor:
    """(P, 3, 3): each point's block of the normal equations at ``ref``
    (with the IRLS weights and its prior)."""
    F, P = prob.obs_mask.shape
    H, _ = _system(prob, ref.R, ref.t, ref.points, huber_delta,
                   torch.finfo(F64).eps)
    i = 6 * F + 3 * torch.arange(P, device=H.device)[:, None] + torch.arange(
        3, device=H.device)
    return H[i[:, :, None], i[:, None, :]]


def gaps(R, t, X, ref: Result, prob: Problem, info: Tensor,
         huber_delta: float | None = None) -> Gaps:
    """The gaps of the solve (R, t, X) (any dtype and device) from
    ``ref``, the points' in the sigmas of ``info``
    (``point_information``), the cost under ``huber_delta``."""
    dev = ref.points.device
    R, t, X = (x.detach().to(dev, F64) for x in (R, t, X))
    rel = R.transpose(-1, -2) @ ref.R
    vee = torch.stack([rel[..., 2, 1] - rel[..., 1, 2],
                       rel[..., 0, 2] - rel[..., 2, 0],
                       rel[..., 1, 0] - rel[..., 0, 1]], -1)
    cos = (rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
    rot = torch.atan2(0.5 * torch.linalg.vector_norm(vee, dim=-1), cos).max()
    base = torch.linalg.vector_norm(ref.t[-1] - ref.t[0])
    trans = (torch.linalg.vector_norm(t - ref.t, dim=-1).max()
             / torch.clamp(base, min=1e-12))
    seen = prob.obs_mask.any(0)
    d = X - ref.points
    pt = torch.sqrt(torch.clamp(torch.einsum("pi,pij,pj->p", d, info, d),
                                min=0))
    depth = torch.abs((ref.points - ref.t[-1]) @ ref.R[-1])[:, 2]
    rel_pt = (torch.linalg.vector_norm(d, dim=-1)
              / torch.clamp(depth, min=1e-12))
    zero = torch.zeros((), dtype=F64)
    point = pt[seen].max() if bool(seen.any()) else zero
    point_rel = rel_pt[seen].max() if bool(seen.any()) else zero
    c = cost(prob, R, t, X, huber_delta) / ref.cost - 1
    return Gaps(float(rot), float(trans), float(point), float(point_rel),
                float(c))
