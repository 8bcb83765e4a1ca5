"""P3P: camera pose from three 3D-2D correspondences, Grunert closed form
(port of ``mvslam_tpu.ops.p3p``).

The depth-ratio quartic is built symbolically from small polynomial
products, solved by real-only Ferrari, each root Newton-polished, and the
depth triples polished on the law-of-cosines system; the rotation aligns
the world and camera orthonormal triads in closed form. Batched over any
leading hypothesis dims.
"""

from __future__ import annotations

import torch

from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.math.linalg import inv3x3

Tensor = torch.Tensor


def _polymul(a: tuple, b: tuple) -> tuple:
    """Product of ascending-coefficient polynomials of batched scalars."""
    out = [0.0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            out[i + j] = out[i + j] + ai * bj
    return tuple(out)


def _polysub(a: tuple, b: tuple) -> tuple:
    n = max(len(a), len(b))
    a = a + (0.0,) * (n - len(a))
    b = b + (0.0,) * (n - len(b))
    return tuple(ai - bi for ai, bi in zip(a, b))


def _polyscale(a: tuple, s) -> tuple:
    return tuple(ai * s for ai in a)


def _cbrt(x: Tensor) -> Tensor:
    """Real, sign-preserving cube root."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _quartic_roots(c0, c1, c2, c3, c4) -> Tensor:
    """Four real root candidates of ``c4 v^4 + ... + c0`` (real-only
    Ferrari; complex pairs surface as near-root real candidates, which the
    polish and residual checks reject). Returns (..., 4)."""
    tiny = torch.finfo(c0.dtype).tiny ** 0.5
    lead = torch.where(torch.abs(c4) > tiny, c4, torch.full_like(c4, tiny))
    a = c3 / lead
    b = c2 / lead
    c = c1 / lead
    d = c0 / lead
    P = b - 3.0 * a * a / 8.0
    Q = c - a * b / 2.0 + a * a * a / 8.0
    R = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * (a ** 4) / 256.0
    B2 = -P
    B1 = -4.0 * R
    B0 = 4.0 * P * R - Q * Q
    p3 = B1 - B2 * B2 / 3.0
    q3 = 2.0 * (B2 ** 3) / 27.0 - B2 * B1 / 3.0 + B0
    disc = (q3 / 2.0) ** 2 + (p3 / 3.0) ** 3
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    w_card = _cbrt(-q3 / 2.0 + sq) + _cbrt(-q3 / 2.0 - sq)
    m = 2.0 * torch.sqrt(torch.clamp(-p3 / 3.0, min=tiny))
    cos_arg = torch.clamp(3.0 * q3 / torch.clamp(p3 * m, max=-tiny), -1.0, 1.0)
    w_trig = m * torch.cos(torch.arccos(cos_arg) / 3.0)
    w = torch.where(disc >= 0, w_card, w_trig)
    z0 = w - B2 / 3.0
    s = torch.sqrt(torch.clamp(z0 - P, min=0.0))
    s_safe = torch.clamp(s, min=tiny)
    t1 = (z0 - Q / s_safe) / 2.0
    t2 = (z0 + Q / s_safe) / 2.0
    d1 = torch.sqrt(torch.clamp(s * s - 4.0 * t1, min=0.0))
    d2 = torch.sqrt(torch.clamp(s * s - 4.0 * t2, min=0.0))
    y = torch.stack([(-s + d1) / 2.0, (-s - d1) / 2.0,
                     (s + d2) / 2.0, (s - d2) / 2.0], dim=-1)
    return y - a[..., None] / 4.0


def _newton_polish(v: Tensor, coeffs, iterations: int = 8) -> Tensor:
    """Real Newton refinement of quartic roots (guarded derivative)."""
    c0, c1, c2, c3, c4 = (c[..., None] for c in coeffs)
    tiny = torch.finfo(v.dtype).tiny ** 0.5
    for _ in range(iterations):
        g = ((4.0 * c4 * v + 3.0 * c3) * v + 2.0 * c2) * v + c1
        g = torch.where(torch.abs(g) > tiny, g, torch.full_like(g, tiny))
        f = (((c4 * v + c3) * v + c2) * v + c1) * v + c0
        v = v - torch.clamp(f / g, -1.0, 1.0)
    return v


def _triad(p0: Tensor, p1: Tensor, p2: Tensor) -> Tensor:
    """Right-handed orthonormal basis (..., 3, 3) columns from 3 points."""
    tiny = torch.finfo(p0.dtype).tiny ** 0.5

    def unit(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True), min=tiny)

    e1 = unit(p1 - p0)
    d2 = p2 - p0
    e2 = unit(d2 - torch.sum(d2 * e1, dim=-1, keepdim=True) * e1)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-1)


def p3p_solve(X: Tensor, f: Tensor) -> tuple[SE3, Tensor]:
    """Camera-to-world pose candidates from 3 world points X (..., 3, 3)
    and 3 unit bearings f (..., 3, 3) (rows index the correspondences):
    an SE3 of batch shape (..., 12) — 4 roots x 3 depth extractions — and a
    (..., 12) validity mask. Invalid candidates are identity poses."""
    dtype = X.dtype
    tiny = torch.finfo(dtype).tiny ** 0.5
    eps = torch.finfo(dtype).eps

    P1, P2, P3 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    f1, f2, f3 = f[..., 0, :], f[..., 1, :], f[..., 2, :]
    a2 = torch.sum((P2 - P3) ** 2, dim=-1)
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)
    p = 2.0 * torch.sum(f2 * f3, dim=-1)
    q = 2.0 * torch.sum(f1 * f3, dim=-1)
    r = 2.0 * torch.sum(f1 * f2, dim=-1)
    b2s = torch.clamp(b2, min=tiny)
    ab = a2 / b2s
    cb = c2 / b2s

    one = torch.ones_like(ab)
    L = (-ab, ab * q, one - ab)
    K = (one - cb, cb * q, -cb)
    M = _polysub(L, K)
    G = (-r, p)
    coeffs = _polysub(
        _polymul(M, M),
        _polysub(_polyscale(_polymul(M, G), r),
                 _polymul(K, _polymul(G, G))),
    )
    v = _newton_polish(_quartic_roots(*coeffs), coeffs)
    c0, c1, c2_, c3, c4 = (c[..., None] for c in coeffs)
    resid = (((c4 * v + c3) * v + c2_) * v + c1) * v + c0
    scale = sum(torch.abs(c)[..., None] for c in coeffs) + tiny
    root_ok = torch.abs(resid) < 1e3 * eps * scale * torch.clamp(
        torch.abs(v), min=1.0) ** 4

    Lv = (L[2][..., None] * v + L[1][..., None]) * v + L[0][..., None]
    Kv = (K[2][..., None] * v + K[1][..., None]) * v + K[0][..., None]
    Gv = p[..., None] * v - r[..., None]
    u_lin = (Lv - Kv) / torch.where(torch.abs(Gv) > tiny, Gv,
                                    torch.full_like(Gv, tiny))
    sq_u = torch.sqrt(torch.clamp(r[..., None] ** 2 / 4.0 - Kv, min=0.0))
    u = torch.stack([u_lin, r[..., None] / 2.0 + sq_u,
                     r[..., None] / 2.0 - sq_u], dim=-1)      # (..., 4, 3)

    den = 1.0 + v * v - q[..., None] * v
    s1_root = torch.sqrt(torch.clamp(b2[..., None], min=0.0)
                         / torch.clamp(den, min=tiny))
    batch = v.shape[:-1]
    s1 = s1_root[..., None].expand(batch + (4, 3)).reshape(batch + (12,))
    s3 = (v * s1_root)[..., None].expand(batch + (4, 3)).reshape(batch + (12,))
    s2 = (u * s1_root[..., None]).reshape(batch + (12,))
    valid = (root_ok & (den > tiny))[..., None].expand(
        batch + (4, 3)).reshape(batch + (12,))
    s1 = torch.where(torch.isfinite(s1), s1, torch.ones_like(s1))
    s2 = torch.where(torch.isfinite(s2), s2, torch.ones_like(s2))
    s3 = torch.where(torch.isfinite(s3), s3, torch.ones_like(s3))

    pq, qq, rq = p[..., None], q[..., None], r[..., None]
    a2q, b2q, c2q = a2[..., None], b2[..., None], c2[..., None]
    zero = torch.zeros_like(s1)

    def constraints(s1, s2, s3):
        return torch.stack([s2 * s2 + s3 * s3 - pq * s2 * s3 - a2q,
                            s1 * s1 + s3 * s3 - qq * s1 * s3 - b2q,
                            s1 * s1 + s2 * s2 - rq * s1 * s2 - c2q], dim=-1)

    for _ in range(8):
        g = constraints(s1, s2, s3)
        J = torch.stack(
            [torch.stack([zero, 2.0 * s2 - pq * s3, 2.0 * s3 - pq * s2], dim=-1),
             torch.stack([2.0 * s1 - qq * s3, zero, 2.0 * s3 - qq * s1], dim=-1),
             torch.stack([2.0 * s1 - rq * s2, 2.0 * s2 - rq * s1, zero], dim=-1)],
            dim=-2,
        )
        delta = (inv3x3(J) @ g[..., None])[..., 0]
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        cap = 0.5 * torch.abs(s1[..., None])
        delta = torch.minimum(torch.maximum(delta, -cap), cap)
        s1 = s1 - delta[..., 0]
        s2 = s2 - delta[..., 1]
        s3 = s3 - delta[..., 2]
    gfin = constraints(s1, s2, s3)
    cscale = (a2q + b2q + c2q) + tiny
    depth_ok = torch.amax(torch.abs(gfin), dim=-1) < 1e4 * eps * cscale
    valid = valid & depth_ok & (s1 > tiny) & (s2 > tiny) & (s3 > tiny)

    Yc = torch.stack([s1[..., None] * f1[..., None, :],
                      s2[..., None] * f2[..., None, :],
                      s3[..., None] * f3[..., None, :]], dim=-2)
    Bw = _triad(P1, P2, P3)
    Bc = _triad(Yc[..., 0, :], Yc[..., 1, :], Yc[..., 2, :])
    R_wc = Bc @ Bw.transpose(-1, -2)[..., None, :, :]
    t_wc = Yc[..., 0, :] - (R_wc @ P1[..., None, :, None])[..., 0]
    finite = torch.all(torch.isfinite(R_wc).flatten(-2), dim=-1) & torch.all(
        torch.isfinite(t_wc), dim=-1)
    valid = valid & finite
    eyeR = torch.eye(3, dtype=dtype, device=X.device).expand(R_wc.shape)
    R_wc = torch.where(valid[..., None, None], R_wc, eyeR)
    t_wc = torch.where(valid[..., None], t_wc, torch.zeros_like(t_wc))
    return SE3(R_wc, t_wc).inverse(), valid
