"""Batched Lucas-Kanade (KLT) sub-pixel refinement (port of
``mvslam_tpu.ops.klt``).

Inverse-compositional, translation-only LK against stored template
patches: one integer-anchored local patch gather per keypoint, then per
iteration a bilinear window sampled by direct gathers — rows first, then
columns, in the same two-term order as the JAX package's interpolation-
matrix products, so the roundings agree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mvslam_tpu_torch.ops.features import extract_patches, sep_filter3

Tensor = torch.Tensor

WINDOW = 13          # patch side (odd)
ITERATIONS = 10
MAX_SHIFT = 4.0      # reject tracks that wander farther than this (px)
#: local-patch halfwidth: window radius + max excursion + bilinear margin
_LOCAL_HW = WINDOW // 2 + int(MAX_SHIFT) + 2
_LOCAL_P = 2 * _LOCAL_HW + 1
#: max offset from the anchor while iterating (stays inside the local patch)
_MAX_OFF = float(_LOCAL_HW - WINDOW // 2 - 1)


class KltResult(NamedTuple):
    xy: Tensor          # (N, 2) refined positions
    valid: Tensor       # (N,) convergence + bounds check
    residual: Tensor    # (N,) mean abs photometric error


def smooth_image(img: Tensor, passes: int = 3) -> Tensor:
    """Separable binomial ([1,2,1]/4) smoothing, ``passes`` times."""
    k = (0.25, 0.5, 0.25)
    x = img
    for _ in range(passes):
        x = sep_filter3(x, k, k)
    return x


def _local_patches(img: Tensor, xy: Tensor) -> tuple[Tensor, Tensor]:
    """(N, P, P) integer-anchored local patches + float anchors (N, 2)."""
    H, W = img.shape
    ax = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, W - 1)
    ay = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, H - 1)
    local = extract_patches(img, xy, _LOCAL_HW)
    return local, torch.stack([ax, ay], dim=-1).to(img.dtype)


def _taps(rel: Tensor, window: int):
    """Two-tap bilinear positions/weights of ``rel + (i - r)``: (N, window)
    floor index (clipped to the patch) and fraction."""
    r = window // 2
    pos = rel[:, None] + torch.arange(-r, r + 1, dtype=rel.dtype,
                                      device=rel.device)[None, :]
    p0 = torch.floor(pos)
    f = pos - p0
    p0i = torch.clamp(p0.to(torch.int64), 0, _LOCAL_P - 2)
    return p0i, f


def _bilinear_from_local(local: Tensor, rel_xy: Tensor, window: int) -> Tensor:
    """Fractional (N, window, window) windows out of (N, P, P) patches."""
    N, P = local.shape[0], local.shape[-1]
    x0, fx = _taps(rel_xy[:, 0], window)
    y0, fy = _taps(rel_xy[:, 1], window)
    n = torch.arange(N, device=local.device)[:, None]
    # rows: tmp[n, i, q] = (1 - fy_i) local[n, y0_i, q] + fy_i local[n, y0_i + 1, q]
    tmp = ((1.0 - fy)[:, :, None] * local[n, y0]
           + fy[:, :, None] * local[n, y0 + 1])               # (N, win, P)
    # cols: out[n, i, j] = tmp[n, i, x0_j] (1 - fx_j) + tmp[n, i, x0_j + 1] fx_j
    c0 = torch.gather(tmp, 2, x0[:, None, :].expand(N, window, window))
    c1 = torch.gather(tmp, 2, (x0 + 1)[:, None, :].expand(N, window, window))
    return c0 * (1.0 - fx)[:, None, :] + c1 * fx[:, None, :]


def extract_templates(img: Tensor, xy: Tensor, window: int = WINDOW) -> Tensor:
    """Template patches (N, W, W), bilinear at fractional ``xy``."""
    local, anchor = _local_patches(img, xy)
    rel = xy.to(img.dtype) - anchor + _LOCAL_HW
    return _bilinear_from_local(local, rel, window)


def _edge_diff(t: Tensor, dim: int) -> Tensor:
    """Central difference along ``dim`` with edge replication."""
    n = t.shape[dim]
    nxt = torch.cat([t.narrow(dim, 1, n - 1), t.narrow(dim, n - 1, 1)], dim=dim)
    prv = torch.cat([t.narrow(dim, 0, 1), t.narrow(dim, 0, n - 1)], dim=dim)
    return 0.5 * (nxt - prv)


def klt_track(templates: Tensor, img: Tensor, xy_init: Tensor, mask: Tensor,
              window: int = WINDOW, iterations: int = ITERATIONS) -> KltResult:
    """Refine positions in ``img`` so the local patch matches ``templates``.
    Invalid/diverged tracks return their initial position, ``valid=False``.
    """
    dtype = img.dtype
    tx = _edge_diff(templates, 2)
    ty = _edge_diff(templates, 1)
    Hxx = torch.sum(tx * tx, dim=(-2, -1))
    Hxy = torch.sum(tx * ty, dim=(-2, -1))
    Hyy = torch.sum(ty * ty, dim=(-2, -1))
    det = Hxx * Hyy - Hxy * Hxy
    tiny = torch.finfo(dtype).tiny ** 0.5
    good_H = det > tiny
    inv_det = 1.0 / torch.where(good_H, det, torch.ones_like(det))
    step_ok = (mask & good_H)[:, None]

    local, anchor = _local_patches(img, xy_init)

    def sample(xy):
        return _bilinear_from_local(local, xy - anchor + _LOCAL_HW, window)

    xy = xy_init.to(dtype)
    for _ in range(iterations):
        e = sample(xy) - templates
        bx = torch.sum(tx * e, dim=(-2, -1))
        by = torch.sum(ty * e, dim=(-2, -1))
        dx = (Hyy * bx - Hxy * by) * inv_det
        dy = (Hxx * by - Hxy * bx) * inv_det
        delta = torch.clamp(torch.stack([dx, dy], dim=-1), -1.5, 1.5)
        new = xy - torch.where(step_ok, delta, torch.zeros_like(delta))
        xy = anchor + torch.clamp(new - anchor, -_MAX_OFF, _MAX_OFF)
    shift = torch.linalg.vector_norm(xy - xy_init, dim=-1)
    residual = torch.mean(torch.abs(sample(xy) - templates), dim=(-2, -1))
    valid = (mask & good_H & (shift <= MAX_SHIFT)
             & torch.all(torch.isfinite(xy), dim=-1))
    xy_out = torch.where(valid[:, None], xy, xy_init)
    return KltResult(xy=xy_out, valid=valid, residual=residual)
