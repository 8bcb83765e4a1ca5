"""Batched small-matrix linear algebra (port of ``mvslam_tpu.math.linalg``).

The closed forms (spectral amplification, Cardano eigensystems, Newton
polar) are ported as written rather than swapped for ``torch.linalg``
calls, so both packages take the same numerical path; where the JAX
package itself calls ``eigh``/``cholesky``/triangular solves, the
``torch.linalg`` counterpart is used. On the CPU the two-vector solver of
the 8-point DLT sums its squarings (:func:`fma.fma_matmul`; the epipolar
module its Gram matrices), its trace and its read-out
(:func:`fma.chain_matmul`) in fixed orders: what MKL computes on AVX-512
Intel hosts, now on every host.
"""

from __future__ import annotations

import math

import torch

from mvslam_tpu_torch.math.fma import chain_matmul, fma_matmul

Tensor = torch.Tensor


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _trace(M: Tensor) -> Tensor:
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)


def _trace_in_order(M: Tensor) -> Tensor:
    """Diagonal sum on the CPU in torch's own order there, written out (four
    interleaved partial sums added in turn) so no kernel's choice moves it;
    on the card the reduction's own order."""
    if M.device.type != "cpu":
        return _trace(M)
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    parts = [d[..., j] for j in range(min(4, d.shape[-1]))]
    for i in range(4, d.shape[-1]):
        parts[i % 4] = parts[i % 4] + d[..., i]
    t = parts[0]
    for part in parts[1:]:
        t = t + part
    return t


def _norm(x: Tensor, keepdim: bool = True) -> Tensor:
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def eigh(M: Tensor) -> tuple[Tensor, Tensor]:
    """``torch.linalg.eigh`` with ``jnp.linalg.eigh``'s failure semantics:
    where the solver does not converge, torch raises and JAX returns NaN
    eigenvalues and eigenvectors, which its callers' finite checks then
    drop. cuSOLVER does so on the float32 refit of an exact 8-point rig,
    and so does the LAPACK of some hosts; here it gives NaN, for the whole
    batch when any matrix of it fails."""
    try:
        return torch.linalg.eigh(M)
    except torch.linalg.LinAlgError:
        nan = torch.full_like(M, math.nan)
        return nan[..., 0], nan


def smallest_eigvec_psd_exact(M: Tensor) -> Tensor:
    """Reference implementation via ``eigh``."""
    _, vecs = eigh(M)
    return vecs[..., :, 0]


def _amplify(M: Tensor, iterations: int, fused: bool = False) -> Tensor:
    """``B = (c I - M) / c`` squared ``iterations`` times, renormalized.

    ``fused``: the shift's trace summed in a fixed order and the squarings
    through :func:`fma_matmul` (XLA's summation), the same bits on every
    CPU. The bottom eigenvalues of an 8-point DLT's Gram matrix lie below
    ``eps32 * trace``, so which of them the squarings single out follows
    the last bits of those sums; a BLAS sums in an order of its own
    choosing."""
    dtype = M.dtype
    n = M.shape[-1]
    tiny = torch.finfo(dtype).tiny
    c = (_trace_in_order(M) if fused else _trace(M))[..., None, None]
    c = torch.abs(c) * (1.0 + torch.finfo(dtype).eps) + tiny
    B = (c * _eye(n, M) - M) / c
    square = fma_matmul if fused else torch.matmul
    for _ in range(iterations):
        B = square(B, B)
        scale = torch.amax(torch.abs(B), dim=(-2, -1), keepdim=True)
        B = B / torch.clamp(scale, min=tiny)
    return B


def _starts(n: int, like: Tensor) -> tuple[Tensor, Tensor]:
    base = torch.arange(1, n + 1, dtype=like.dtype, device=like.device)
    return torch.sin(base * 12.9898) + 0.5, torch.cos(base * 78.233) - 0.25


def smallest_eigvec_psd(M: Tensor, iterations: int = 8) -> Tensor:
    """Unit eigenvector of the smallest eigenvalue of a symmetric PSD batch,
    by spectral power amplification (pure batched matmuls)."""
    n = M.shape[-1]
    tiny = torch.finfo(M.dtype).tiny
    iterations = max(iterations, 12) if n > 2 else iterations
    B = _amplify(M, iterations)
    s1, s2 = _starts(n, M)

    def read(s):
        x = (B @ s.expand(M.shape[:-1])[..., None])[..., 0]
        return x / torch.clamp(_norm(x), min=tiny)

    x1 = read(s1)
    x2 = read(s2)
    r1 = torch.sum(x1 * (M @ x1[..., None])[..., 0], dim=-1)
    r2 = torch.sum(x2 * (M @ x2[..., None])[..., 0], dim=-1)
    return torch.where((r1 <= r2)[..., None], x1, x2)


def homogeneous_solve(A: Tensor) -> Tensor:
    """argmin_{|x|=1} |A x| for (..., m, n): smallest right singular
    vector."""
    return smallest_eigvec_psd(A.transpose(-1, -2) @ A)


def smallest_eigvecs2_psd(M: Tensor, iterations: int = 8
                          ) -> tuple[Tensor, Tensor]:
    """Orthonormal basis (v1, v2) of the 2-dim bottom-eigenvalue subspace
    of a symmetric PSD batch (same amplification core as
    :func:`smallest_eigvec_psd`)."""
    dtype = M.dtype
    n = M.shape[-1]
    tiny = torch.finfo(dtype).tiny
    eye = _eye(n, M)
    iterations = max(iterations, 24) if n > 2 else iterations
    B = _amplify(M, iterations, fused=True)
    s1, s2 = _starts(n, M)
    starts = torch.stack([s1, s2], dim=-1)                 # (n, 2)
    X = chain_matmul(B, starts.expand(M.shape[:-2] + (n, 2)))
    x1 = X[..., 0]
    x2 = X[..., 1]
    v1 = x1 / torch.clamp(_norm(x1), min=tiny)
    n2_pre = _norm(x2)
    x2 = x2 - torch.sum(v1 * x2, dim=-1, keepdim=True) * v1
    n2 = _norm(x2)
    fb = eye[:, 0].expand(v1.shape)
    fb = fb - torch.sum(v1 * fb, dim=-1, keepdim=True) * v1
    fb2 = eye[:, min(1, n - 1)].expand(v1.shape)
    fb2 = fb2 - torch.sum(v1 * fb2, dim=-1, keepdim=True) * v1
    fb = torch.where(_norm(fb) > 0.1, fb, fb2)
    eps2 = torch.finfo(dtype).eps * 16
    sin2 = n2 / torch.clamp(n2_pre, min=tiny)
    x2 = torch.where(sin2 > eps2, x2, fb)
    v2 = x2 / torch.clamp(_norm(x2), min=tiny)
    return v1, v2


def _cardano(H: Tensor):
    """Shift/scale of a symmetric 3x3 batch for the trigonometric
    eigenvalue formula: (q, p, phi)."""
    dtype = H.dtype
    tiny = torch.finfo(dtype).tiny ** 0.5
    q = _trace(H) / 3.0
    A = H - q[..., None, None] * _eye(3, H)
    p2 = torch.sum(A * A, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=tiny))
    B = A / p[..., None, None]
    r = torch.clamp(det3(B) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    return q, p, phi


def _axis(i: int, shape, like: Tensor) -> Tensor:
    """Unit vector ``e_i`` broadcast to ``shape`` (built on the device)."""
    return _eye(3, like)[i].expand(shape)


def _adjugate_vec(H: Tensor, lam: Tensor, fallback: int) -> Tensor:
    """Unit null vector of ``H - lam I`` from its best row cross product."""
    dtype = H.dtype
    tiny = torch.finfo(dtype).tiny ** 0.5
    As = H - lam[..., None, None] * _eye(3, H)
    r0, r1, r2 = As[..., 0, :], As[..., 1, :], As[..., 2, :]
    cands = torch.stack([_cross(r0, r1), _cross(r1, r2), _cross(r2, r0)],
                        dim=-2)
    norms = torch.linalg.vector_norm(cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    nv = _norm(v)
    return torch.where(nv > tiny, v / torch.clamp(nv, min=tiny),
                       _axis(fallback, v.shape, H))


def eigh3x3_full(H: Tensor) -> tuple[Tensor, Tensor]:
    """All (eigenvalues DESCENDING, eigenvector COLUMNS) of a symmetric 3x3
    batch in closed form (Cardano + adjugate cross products)."""
    dtype = H.dtype
    tiny = torch.finfo(dtype).tiny ** 0.5
    q, p, phi = _cardano(H)
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3
    v1 = _adjugate_vec(H, lam1, 0)
    v3 = _adjugate_vec(H, lam3, 2)
    v3 = v3 - torch.sum(v1 * v3, dim=-1, keepdim=True) * v1
    n3 = _norm(v3)
    fb = _axis(1, v1.shape, H)
    fb = fb - torch.sum(v1 * fb, dim=-1, keepdim=True) * v1
    v3 = torch.where(n3 > tiny, v3 / torch.clamp(n3, min=tiny),
                     fb / torch.clamp(_norm(fb), min=tiny))
    v2 = _cross(v3, v1)
    return (torch.stack([lam1, lam2, lam3], dim=-1),
            torch.stack([v1, v2, v3], dim=-1))


def svd3x3(M: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Closed-form batched 3x3 SVD ``M = U diag(s) V^T``, s descending."""
    dtype = M.dtype
    tiny = torch.finfo(dtype).tiny ** 0.5
    eps = torch.finfo(dtype).eps
    lams, V = eigh3x3_full(M.transpose(-1, -2) @ M)
    s = torch.sqrt(torch.clamp(lams, min=0.0))
    MV = M @ V
    ok = s > (s[..., :1] * eps * 64 + tiny)
    u1 = MV[..., :, 0] / torch.clamp(s[..., 0, None], min=tiny)
    u2 = MV[..., :, 1] / torch.clamp(s[..., 1, None], min=tiny)
    u3 = MV[..., :, 2] / torch.clamp(s[..., 2, None], min=tiny)

    def unit(x):
        return x / torch.clamp(_norm(x), min=tiny)

    u1 = torch.where(ok[..., 0, None], unit(u1), _axis(0, u1.shape, M))
    u2 = u2 - torch.sum(u1 * u2, dim=-1, keepdim=True) * u1
    fb2 = _axis(1, u1.shape, M)
    fb2 = fb2 - torch.sum(u1 * fb2, dim=-1, keepdim=True) * u1
    u2 = torch.where(ok[..., 1, None] & (_norm(u2) > eps * 16),
                     unit(u2), unit(fb2 + tiny))
    u3c = _cross(u1, u2)
    u3 = torch.where(ok[..., 2, None], unit(u3), u3c)
    u3 = torch.where(torch.abs(torch.sum(u3 * u3c, dim=-1, keepdim=True)) > 0.5,
                     u3, u3c)
    U = torch.stack([u1, u2, u3], dim=-1)
    return U, s, V.transpose(-1, -2)


def project_to_so3_svd(M: Tensor) -> Tensor:
    """Nearest rotation via a full SVD (the oracle of
    :func:`project_to_so3`)."""
    U, _, Vt = torch.linalg.svd(M)
    D = torch.ones(M.shape[:-2] + (3,), dtype=M.dtype, device=M.device)
    D[..., 2] = torch.linalg.det(U @ Vt)
    return (U * D[..., None, :]) @ Vt


def polar_orthogonal(M: Tensor, iterations: int = 7) -> Tensor:
    """Orthogonal polar factor of ``M`` by determinant-scaled Newton."""
    dtype = M.dtype
    tiny = torch.finfo(dtype).tiny ** 0.5
    fro = torch.sqrt(torch.sum(M * M, dim=(-2, -1), keepdim=True))
    X = M * (math.sqrt(3.0) / torch.clamp(fro, min=tiny))
    for _ in range(iterations):
        g = torch.abs(det3(X))[..., None, None]
        g = torch.clamp(torch.clamp(g, min=tiny) ** (-1.0 / 3.0), 1e-4, 1e4)
        Xs = X * g
        X = 0.5 * (Xs + inv3x3(Xs).transpose(-1, -2))
    return X


def eigh3x3_smallest(H: Tensor) -> tuple[Tensor, Tensor]:
    """Smallest (eigenvalue, unit eigenvector) of a symmetric 3x3 batch."""
    q, p, phi = _cardano(H)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return lam_min, _adjugate_vec(H, lam_min, 0)


def project_to_so3(M: Tensor) -> Tensor:
    """Nearest rotation matrix (Frobenius) without an SVD."""
    Q = polar_orthogonal(M)
    H = Q.transpose(-1, -2) @ M
    _, v = eigh3x3_smallest(0.5 * (H + H.transpose(-1, -2)))
    flip_R = _eye(3, M) - 2.0 * v[..., :, None] * v[..., None, :]
    detQ = det3(Q)
    return torch.where((detQ < 0)[..., None, None], Q @ flip_R, Q)


def _cholesky(A: Tensor) -> Tensor:
    """Cholesky factor, NaN-filled where ``A`` is not positive definite
    (the JAX package's semantics; ``torch.linalg.cholesky`` would raise)."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def solve_psd(A: Tensor, b: Tensor, jitter: float = 0.0) -> Tensor:
    """Solve ``A x = b`` for symmetric positive definite ``A`` via Cholesky."""
    if jitter:
        A = A + jitter * _eye(A.shape[-1], A)
    L = _cholesky(A)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0]


def inv_psd(A: Tensor, jitter: float = 0.0) -> Tensor:
    """Inverse of a symmetric positive definite matrix via Cholesky."""
    if jitter:
        A = A + jitter * _eye(A.shape[-1], A)
    L = _cholesky(A)
    eye = _eye(A.shape[-1], A).expand(A.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.transpose(-1, -2) @ Linv


def det3(M: Tensor) -> Tensor:
    """Closed-form 3x3 determinant, batched (cofactor expansion; the JAX
    package's LU ``det`` agrees to rounding)."""
    return (
        M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
        - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
        + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0])
    )


def inv3x3(A: Tensor) -> Tensor:
    """Closed-form 3x3 inverse (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    adj = torch.stack(
        [torch.stack([co00, co01, co02], dim=-1),
         torch.stack([co10, co11, co12], dim=-1),
         torch.stack([co20, co21, co22], dim=-1)],
        dim=-2,
    )
    return adj / det[..., None, None]
