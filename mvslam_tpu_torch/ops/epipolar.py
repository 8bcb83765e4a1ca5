"""Epipolar geometry: batched degeneracy-robust 8-point essential matrix,
Sampson errors and the 5-dof Sampson pose polish (port of
``mvslam_tpu.ops.epipolar``).

Point sets are fixed-capacity (N, 2|3) tensors with a weight/mask;
masked rows contribute zero DLT rows. Every routine accepts a leading
hypothesis axis.
"""

from __future__ import annotations

import math

import torch

from mvslam_tpu_torch.math import fma, linalg
from mvslam_tpu_torch.math.lie import SE3, skew, so3_exp

Tensor = torch.Tensor


def normalization_transform(points: Tensor, weights: Tensor) -> Tensor:
    """Hartley conditioning transform (..., 3, 3) of a weighted 2D point
    set: centroid to the origin, mean distance to sqrt(2)."""
    dtype = points.dtype
    wsum = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1.0)
    centroid = torch.sum(points * weights[..., None], dim=-2) / wsum
    d = torch.linalg.vector_norm(points - centroid[..., None, :], dim=-1)
    mean_dist = torch.sum(d * weights, dim=-1) / wsum[..., 0]
    scale = math.sqrt(2.0) / torch.clamp(
        mean_dist, min=torch.finfo(dtype).tiny ** 0.5)
    zeros = torch.zeros_like(scale)
    ones = torch.ones_like(scale)
    return torch.stack(
        [torch.stack([scale, zeros, -scale * centroid[..., 0]], dim=-1),
         torch.stack([zeros, scale, -scale * centroid[..., 1]], dim=-1),
         torch.stack([zeros, zeros, ones], dim=-1)],
        dim=-2,
    )


def _dlt_rows(p1: Tensor, p2: Tensor) -> Tensor:
    """Rows of ``p2^T F p1 = 0``: (..., N, 9)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    return torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1)


def _cbrt(x: Tensor) -> Tensor:
    """Real, sign-preserving cube root (torch has no ``cbrt``)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _cubic_roots_real(c3: Tensor, c2: Tensor, c1: Tensor, c0: Tensor) -> Tensor:
    """Real roots of ``c3 t^3 + c2 t^2 + c1 t + c0`` -> (..., 3); extras
    duplicate a real root when fewer than three exist."""
    tiny = torch.finfo(c3.dtype).tiny ** 0.5
    c3_safe = torch.where(torch.abs(c3) < tiny, torch.full_like(c3, tiny), c3)
    a = c2 / c3_safe
    b = c1 / c3_safe
    c = c0 / c3_safe
    p = b - a * a / 3.0
    q = 2.0 * a ** 3 / 27.0 - a * b / 3.0 + c
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    p_neg = torch.clamp(p, max=-tiny)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    arg = torch.clamp(3.0 * q / (p_neg * m), -1.0, 1.0)
    phi = torch.arccos(arg)
    k = torch.arange(3, dtype=c3.dtype, device=c3.device)
    s_tri = m[..., None] * torch.cos((phi[..., None] - 2.0 * math.pi * k) / 3.0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    s_car = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)
    s = torch.where(disc[..., None] < 0, s_tri, s_car[..., None])
    return s - a[..., None] / 3.0


def _dlt_gram(p1: Tensor, p2: Tensor, weights: Tensor,
              use_eigh: bool = False) -> Tensor:
    """The weighted DLT's Gram matrix ``A^T A``, (..., 9, 9)."""
    A = _dlt_rows(p1, p2) * weights[..., None]
    At = A.transpose(-1, -2)
    return At @ A if use_eigh else fma.fma_matmul(At, A)


def _span_of_eigvecs(V: Tensor) -> tuple[Tensor, Tensor]:
    """The two smallest-eigenvalue solutions of ``eigh``'s eigenvectors
    (..., 9, 9) (ascending eigenvalues), (..., 3, 3) each."""
    shape = V.shape[:-2] + (3, 3)
    return V[..., :, 0].reshape(shape), V[..., :, 1].reshape(shape)


def _solve_epipolar_span(p1: Tensor, p2: Tensor, weights: Tensor,
                         use_eigh: bool = False) -> tuple[Tensor, Tensor]:
    """Two smallest-eigenvalue DLT solutions, (..., 3, 3) each."""
    AtA = _dlt_gram(p1, p2, weights, use_eigh)
    if use_eigh:
        return _span_of_eigvecs(linalg.eigh(AtA)[1])
    v1, v2 = linalg.smallest_eigvecs2_psd(AtA)
    shape = AtA.shape[:-2] + (3, 3)
    return v1.reshape(shape), v2.reshape(shape)


def _span_candidates(E1: Tensor, E2: Tensor) -> Tensor:
    """Rank-deficient candidates ``E1 + t E2`` (det = 0 cubic roots) plus
    the raw basis, Frobenius-normalized: (..., 5, 3, 3)."""
    det3 = linalg.det3
    d0 = det3(E1)
    d1 = det3(E1 + E2)
    dm1 = det3(E1 - E2)
    d2 = det3(E1 + 2.0 * E2)
    c0 = d0
    c2 = 0.5 * (d1 + dm1) - c0
    half_odd = 0.5 * (d1 - dm1)
    c3 = ((d2 - c0 - 4.0 * c2) * 0.5 - half_odd) / 3.0
    c1 = half_odd - c3
    ts = _cubic_roots_real(c3, c2, c1, c0)
    cands = E1[..., None, :, :] + ts[..., :, None, None] * E2[..., None, :, :]
    cands = torch.cat([cands, E1[..., None, :, :], E2[..., None, :, :]], dim=-3)
    norm = torch.linalg.matrix_norm(cands, keepdim=True)
    return cands / torch.clamp(norm, min=torch.finfo(E1.dtype).tiny)


def _project_essential(E: Tensor) -> Tensor:
    """``E = U diag(s, s, 0) V^T`` with ``s = (s1 + s2) / 2``."""
    U, s, Vt = linalg.svd3x3(E)
    s_mean = 0.5 * (s[..., 0] + s[..., 1])
    s_new = torch.stack([s_mean, s_mean, torch.zeros_like(s_mean)], dim=-1)
    return (U * s_new[..., None, :]) @ Vt


def _pick_best(cands: Tensor, err: Tensor, weights: Tensor) -> Tensor:
    """Best candidate (..., 3, 3) of (..., C, 3, 3) by weighted residual."""
    total = torch.sum(err * weights[..., None, :], dim=-1)
    best = torch.argmin(total, dim=-1)
    idx = best[..., None, None, None].expand(best.shape + (1, 3, 3))
    return torch.gather(cands, -3, idx)[..., 0, :, :]


def _apply_transform2d(T: Tensor, p: Tensor) -> Tensor:
    """Apply homogeneous 3x3 to 2D points (..., N, 2)."""
    return p @ T[..., :2, :2].transpose(-1, -2) + T[..., None, :2, 2]


def _project_rank2(F: Tensor) -> Tensor:
    """Zero the smallest singular value (fundamental-matrix structure)."""
    U, s, Vt = linalg.svd3x3(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return (U * s[..., None, :]) @ Vt


def find_fundamental_matrix(p1: Tensor, p2: Tensor, weights: Tensor,
                            use_eigh: bool = False) -> Tensor:
    """Hartley-normalized fundamental matrix (``|F|_F = 1``) from pixel
    coordinates (..., N, 2), batched: DLT null span on conditioned points,
    det-cubic candidates, rank-2 projection, denormalization ``T2^T F'
    T1``, best by weighted Sampson error."""
    T1 = normalization_transform(p1, weights)
    T2 = normalization_transform(p2, weights)
    q1 = _apply_transform2d(T1, p1)
    q2 = _apply_transform2d(T2, p2)
    F1, F2 = _solve_epipolar_span(q1, q2, weights, use_eigh=use_eigh)
    cands = _project_rank2(_span_candidates(F1, F2))
    cands = T2.transpose(-1, -2)[..., None, :, :] @ cands @ T1[..., None, :, :]
    norm = torch.linalg.matrix_norm(cands, keepdim=True)
    cands = cands / torch.clamp(norm, min=torch.finfo(p1.dtype).tiny)
    h1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    h2 = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)
    err = sampson_error(cands, h1[..., None, :, :], h2[..., None, :, :])
    return _pick_best(cands, err, weights)


def find_essential_matrix(r1: Tensor, r2: Tensor, weights: Tensor,
                          use_eigh: bool = False) -> Tensor:
    """Essential matrix (``|E|_F = 1``) from ideal-camera rays (..., N, 3),
    batched: DLT null span, det-cubic candidates, essential projection,
    best by weighted Sampson error."""
    E1, E2 = _solve_epipolar_span(r1[..., :2], r2[..., :2], weights,
                                  use_eigh=use_eigh)
    return _essential_of_span(E1, E2, r1, r2, weights)


def essential_gram(r1: Tensor, r2: Tensor, weights: Tensor) -> Tensor:
    """``find_essential_matrix(..., use_eigh=True)`` up to its ``eigh``:
    the Gram matrix (..., 9, 9) that :func:`essential_of_eigvecs` takes
    the eigenvectors of."""
    return _dlt_gram(r1[..., :2], r2[..., :2], weights, use_eigh=True)


def essential_of_eigvecs(V: Tensor, r1: Tensor, r2: Tensor,
                         weights: Tensor) -> Tensor:
    """``find_essential_matrix(..., use_eigh=True)`` after its ``eigh``,
    given the eigenvectors ``V`` of :func:`essential_gram`'s matrix."""
    E1, E2 = _span_of_eigvecs(V)
    return _essential_of_span(E1, E2, r1, r2, weights)


def _essential_of_span(E1: Tensor, E2: Tensor, r1: Tensor, r2: Tensor,
                       weights: Tensor) -> Tensor:
    p1 = r1[..., :2]
    p2 = r2[..., :2]
    cands = _project_essential(_span_candidates(E1, E2))
    h1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    h2 = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)
    err = sampson_error(cands, h1[..., None, :, :], h2[..., None, :, :])
    return _pick_best(cands, err, weights)


def _sampson_parts(E: Tensor, r1: Tensor, r2: Tensor):
    Er1 = r1 @ E.transpose(-1, -2)                  # (..., N, 3): E r1
    Etr2 = r2 @ E                                   # (..., N, 3): E^T r2
    den = (Er1[..., 0] ** 2 + Er1[..., 1] ** 2
           + Etr2[..., 0] ** 2 + Etr2[..., 1] ** 2)
    return Er1, den


def epipolar_residual(E: Tensor, r1: Tensor, r2: Tensor) -> Tensor:
    """Algebraic epipolar residual ``|r2^T E r1|`` per point, (..., N)."""
    return torch.abs(torch.sum(r2 * (r1 @ E.transpose(-1, -2)), dim=-1))


def sampson_error(E: Tensor, r1: Tensor, r2: Tensor) -> Tensor:
    """First-order geometric (Sampson) error per point, (..., N)."""
    Er1, den = _sampson_parts(E, r1, r2)
    num = torch.sum(r2 * Er1, dim=-1) ** 2
    return num / torch.clamp(den, min=torch.finfo(E.dtype).tiny)


def sampson_weights(E: Tensor, r1: Tensor, r2: Tensor) -> Tensor:
    """Inverse Sampson denominators ``1 / d_i`` per point, (..., N)."""
    _, den = _sampson_parts(E, r1, r2)
    return 1.0 / torch.clamp(den, min=torch.finfo(E.dtype).eps)


def essential_from_pose(pose2in1: SE3) -> Tensor:
    """E (unit Frobenius norm) from the relative camera pose ``pose2in1``."""
    T21 = pose2in1.inverse()
    E = skew(T21.t) @ T21.R
    norm = torch.linalg.matrix_norm(E, keepdim=True)
    return E / torch.clamp(norm, min=torch.finfo(E.dtype).tiny)


def refine_relative_pose_sampson(pose2in1: SE3, r1: Tensor, r2: Tensor,
                                 weights: Tensor, iterations: int = 6) -> SE3:
    """Gauss-Newton on the Sampson cost over the 5-dof relative pose
    (so(3) rotation + 2-dof unit-sphere translation); exact Jacobians by
    forward-mode autodiff (``torch.func.jacfwd``). Returns ``|t| = 1``."""
    dtype = r1.dtype
    tiny = torch.finfo(dtype).tiny ** 0.5
    eye3 = torch.eye(3, dtype=dtype, device=r1.device)

    def apply_params(params, R, t):
        dr, dt = params[:3], params[3:]
        # batch of one: under forward-mode AD, arithmetic between a 0-dim
        # tensor and a python float promotes the tangent to float64
        Rn = R @ so3_exp(dr[None])[0]
        ref = torch.where(torch.abs(t[0]) < 0.9, eye3[0], eye3[1])
        b1 = torch.linalg.cross(t, ref)
        b1 = b1 / torch.clamp(torch.linalg.vector_norm(b1), min=tiny)
        b2 = torch.linalg.cross(t, b1)
        tn = t + b1 * dt[0] + b2 * dt[1]
        tn = tn / torch.clamp(torch.linalg.vector_norm(tn), min=tiny)
        return Rn, tn

    def signed_sampson(params, R, t):
        Rn, tn = apply_params(params, R, t)
        E = skew(tn) @ Rn
        E = E / torch.clamp(torch.linalg.matrix_norm(E), min=tiny)
        Er1 = r1 @ E.T
        Etr2 = r2 @ E
        a = torch.sum(r2 * Er1, dim=-1)
        d = (Er1[..., 0] ** 2 + Er1[..., 1] ** 2
             + Etr2[..., 0] ** 2 + Etr2[..., 1] ** 2)
        return a / torch.sqrt(torch.clamp(d, min=tiny)) * weights

    jac = torch.func.jacfwd(signed_sampson)
    T21 = pose2in1.inverse()
    R, t = T21.R, T21.t
    eye5 = torch.eye(5, dtype=dtype, device=r1.device)
    for _ in range(iterations):
        zero = torch.zeros(5, dtype=dtype, device=r1.device)
        res = signed_sampson(zero, R, t)
        J = jac(zero, R, t)                                  # (N, 5)
        H = J.T @ J
        g = -J.T @ res
        jitter = torch.finfo(dtype).eps * (1.0 + torch.max(torch.abs(H)))
        delta, _ = torch.linalg.solve_ex(H + jitter * eye5, g)
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        new_cost = torch.sum(signed_sampson(delta, R, t) ** 2)
        ok = new_cost < torch.sum(res ** 2)
        R, t = apply_params(torch.where(ok, delta, torch.zeros_like(delta)),
                            R, t)
    return SE3(R, t).inverse()


def decompose_essential_matrix(E: Tensor) -> tuple[Tensor, Tensor]:
    """E -> 4 candidate (R, t), ``|t| = 1``: (..., 4, 3, 3), (..., 4, 3) in
    the order (R1, +t), (R1, -t), (R2, +t), (R2, -t)."""
    U, _, Vt = linalg.svd3x3(E)
    W = torch.zeros(3, 3, dtype=E.dtype, device=E.device)
    # fills, not item assignments: those copy a host scalar, which a CUDA
    # graph cannot capture
    W[0, 1].fill_(-1.0)
    W[1, 0].fill_(1.0)
    W[2, 2].fill_(1.0)
    one = torch.ones((), dtype=E.dtype, device=E.device)
    U = U * torch.where(linalg.det3(U) < 0, -one, one)[..., None, None]
    Vt = Vt * torch.where(linalg.det3(Vt) < 0, -one, one)[..., None, None]
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))
