"""The plain reference of the feature front: a frozen copy of the plain
torch path of ``mvslam_tpu_torch/ops/features.py`` (the scale pyramid,
FAST-9/16 max-margin score, strict 3x3 NMS, border suppression, Harris
rank: ``features_cuda.fast_nms_harris_rank_ref``; then per level the
stable top-k, the patch gather, the intensity-centroid angle and the
256-bit rBRIEF words of ``_orb_detect_unrolled``, integer anchors).

It imports nothing of the port: later changes to the program cannot move
it. ``dtype`` sets the precision the whole front computes in; the
benchmark's comparison runs it in float32, the configurations' precision,
and its control in bfloat16.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_FAST_CIRCLE = (
    (3, 0), (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3), (1, -3), (2, -2),
    (3, -1),
)
PATCH_RADIUS = 15
DESCRIPTOR_BITS = 256


class Orb(NamedTuple):
    """The detector's settings (the fields of the port's ``OrbParams`` the
    unrolled, integer-anchored path reads)."""

    max_features: int = 512
    fast_threshold: float = 20.0 / 255.0
    harris_k: float = 0.04
    num_levels: int = 8
    scale_factor: float = 1.2
    border: int = PATCH_RADIUS + 4


class Features(NamedTuple):
    xy: Tensor          # (K, 2) level-0 pixels
    level: Tensor       # (K,) int64
    desc: Tensor        # (K, 8) int32 words
    mask: Tensor        # (K,) bool


def brief_pattern() -> np.ndarray:
    """256 pairs of (x, y) offsets, Gaussian around the patch centre,
    clipped to the disc, from the port's seeded numpy recipe."""
    rng = np.random.default_rng(0x0B5E55ED)
    pts = rng.normal(0.0, PATCH_RADIUS / 3.0, size=(DESCRIPTOR_BITS, 2, 2))
    r = PATCH_RADIUS - 2
    return np.clip(pts, -r, r).astype(np.float32)


_PATTERN = brief_pattern()


def to_image(frame_u8: Tensor) -> Tensor:
    """An 8-bit frame as the float32 image in [0, 1] the tracker takes:
    the one conversion the timed path and the reference share."""
    return frame_u8.to(torch.float32) / 255.0


def _pad(img: Tensor, pad: int, mode: str = "constant",
         value: float = 0.0) -> Tensor:
    if mode == "constant":
        return F.pad(img, (pad, pad, pad, pad), value=value)
    lead = img.shape[:-2]
    x = F.pad(img.reshape((-1, 1) + img.shape[-2:]), (pad, pad, pad, pad),
              mode=mode)
    return x.reshape(lead + x.shape[-2:])


def _window(p: Tensor, pad: int, dx: int, dy: int, shape) -> Tensor:
    H, W = shape[-2:]
    return p[..., pad + dy: pad + dy + H, pad + dx: pad + dx + W]


def _shift0(img: Tensor, dx: int, dy: int) -> Tensor:
    return _window(_pad(img, 1), 1, dx, dy, img.shape)


def _sep3(img: Tensor, kv, kh) -> Tensor:
    a = img * kv[1]
    if kv[0]:
        a = a + kv[0] * _shift0(img, 0, -1)
    if kv[2]:
        a = a + kv[2] * _shift0(img, 0, 1)
    b = a * kh[1]
    if kh[0]:
        b = b + kh[0] * _shift0(a, -1, 0)
    if kh[2]:
        b = b + kh[2] * _shift0(a, 1, 0)
    return b


def fast_score(img: Tensor, threshold: float) -> Tensor:
    p = _pad(img, 3, mode="replicate")
    ring = torch.stack([_window(p, 3, dx, dy, img.shape)
                        for dx, dy in _FAST_CIRCLE])
    bright = ring - img[None] - threshold
    dark = img[None] - ring - threshold

    def arc9_min(m):
        m2 = torch.minimum(m, torch.roll(m, -1, dims=0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, dims=0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, dims=0))
        return torch.minimum(m8, torch.roll(m, -8, dims=0))

    score = torch.maximum(torch.amax(arc9_min(bright), dim=0),
                          torch.amax(arc9_min(dark), dim=0))
    return torch.clamp(score, min=0.0)


def nms3x3(score: Tensor) -> Tensor:
    p = _pad(score, 1, value=-math.inf)
    nbr = torch.stack([_window(p, 1, dx, dy, score.shape)
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                       if not (dx == 0 and dy == 0)])
    return torch.where(score >= torch.amax(nbr, dim=0), score,
                       torch.zeros_like(score))


def _box_sum(img: Tensor, radius: int) -> Tensor:
    k = 2 * radius + 1

    def win(x, dim):
        c = torch.cumsum(x, dim=dim)
        c = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c], dim=dim)
        n = c.shape[dim]
        return c.narrow(dim, k, n - k) - c.narrow(dim, 0, n - k)

    p = _pad(img, radius)
    return win(win(p, img.dim() - 2), img.dim() - 1)


def _box_sum_shifts(img: Tensor, radius: int) -> Tensor:
    def axis_sum(x, dim):
        pad = [0, 0] * (x.dim() - 1 - dim) + [radius, radius]
        p = F.pad(x, pad)
        out = x * 0
        for o in range(2 * radius + 1):
            out = out + p.narrow(dim, o, x.shape[dim])
        return out

    return axis_sum(axis_sum(img, img.dim() - 2), img.dim() - 1)


def harris_response(img: Tensor, k: float, block_radius: int = 3) -> Tensor:
    smooth = (0.125, 0.25, 0.125)
    diff = (-1.0, 0.0, 1.0)
    Ix = _sep3(img, smooth, diff)
    Iy = _sep3(img, diff, smooth)
    Sxx = _box_sum(Ix * Ix, block_radius)
    Syy = _box_sum(Iy * Iy, block_radius)
    Sxy = _box_sum(Ix * Iy, block_radius)
    return Sxx * Syy - Sxy * Sxy - k * (Sxx + Syy) * (Sxx + Syy)


def _suppress_border(score: Tensor, border: int) -> Tensor:
    H, W = score.shape
    y = torch.arange(H, device=score.device)[:, None]
    x = torch.arange(W, device=score.device)[None, :]
    ok = (y >= border) & (y < H - border) & (x >= border) & (x < W - border)
    return torch.where(ok, score, torch.zeros_like(score))


def rank_map(img: Tensor, orb: Orb) -> Tensor:
    """Harris where a FAST corner survives strict NMS and the border, -inf
    elsewhere (K1's output for one level)."""
    score = _suppress_border(nms3x3(fast_score(img, orb.fast_threshold)),
                             orb.border)
    harris = harris_response(img, orb.harris_k)
    return torch.where(score > 0, harris, torch.full_like(harris, -math.inf))


def level_shapes(H: int, W: int, orb: Orb) -> list[tuple[int, int]]:
    shapes = [(H, W)]
    inv = 1.0 / orb.scale_factor
    for _ in range(1, orb.num_levels):
        h, w = shapes[-1]
        shapes.append((max(int(round(h * inv)), 2 * orb.border + 1),
                       max(int(round(w * inv)), 2 * orb.border + 1)))
    return shapes


def level_budgets(orb: Orb) -> np.ndarray:
    inv = 1.0 / orb.scale_factor
    raw = np.array([inv ** (2 * lv) for lv in range(orb.num_levels)])
    budgets = np.maximum((orb.max_features * raw / raw.sum()).astype(int), 1)
    budgets[0] += orb.max_features - budgets.sum()
    return budgets


def pyramid(img: Tensor, orb: Orb) -> list[Tensor]:
    """Level 0 is ``img``; each further level an antialiased bilinear
    resize (half-pixel centres) of the one before, stored in ``img``'s
    type (torch resizes so in float32 alone)."""
    levels = [img]
    for shape in level_shapes(img.shape[0], img.shape[1], orb)[1:]:
        levels.append(F.interpolate(levels[-1].float()[None, None], size=shape,
                                    mode="bilinear", align_corners=False,
                                    antialias=True)[0, 0].to(img.dtype))
    return levels


def _patches(img: Tensor, xy: Tensor, radius: int) -> Tensor:
    P = 2 * radius + 1
    H, W = img.shape
    padded = _pad(img, radius, mode="replicate")
    x0 = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, W - 1)
    y0 = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, H - 1)
    off = torch.arange(P, device=img.device)
    return padded[(y0[:, None] + off[None, :])[:, :, None],
                  (x0[:, None] + off[None, :])[:, None, :]]


def _orientation(patches: Tensor) -> Tensor:
    P = patches.shape[-1]
    c = (P - 1) / 2.0
    ar = torch.arange(P, dtype=patches.dtype, device=patches.device)
    yy = ar[:, None] - c
    xx = ar[None, :] - c
    disc = ((yy ** 2 + xx ** 2) <= PATCH_RADIUS ** 2).to(patches.dtype)
    m10 = torch.sum(patches * (xx * disc)[None], dim=(-2, -1))
    m01 = torch.sum(patches * (yy * disc)[None], dim=(-2, -1))
    return torch.atan2(m01, m10)


def _descriptors(patches_smooth: Tensor, angles: Tensor) -> Tensor:
    K, P = patches_smooth.shape[0], patches_smooth.shape[-1]
    c = (P - 1) / 2.0
    pat = torch.as_tensor(_PATTERN, dtype=patches_smooth.dtype,
                          device=patches_smooth.device)
    cos = torch.cos(angles)[:, None, None]
    sin = torch.sin(angles)[:, None, None]
    x, y = pat[None, ..., 0], pat[None, ..., 1]
    xi = torch.clamp(torch.round(cos * x - sin * y + c), 0, P - 1).long()
    yi = torch.clamp(torch.round(sin * x + cos * y + c), 0, P - 1).long()
    kk = torch.arange(K, device=patches_smooth.device)[:, None, None]
    s = patches_smooth[kk, yi, xi]
    bits = (s[..., 0] < s[..., 1]).reshape(K, 8, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, device=bits.device)
    words = torch.sum(bits * weights, dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def detect(img: Tensor, orb: Orb,
           dtype: torch.dtype = torch.float32) -> tuple[Features, list]:
    """Keypoints and descriptors of one float32 image, computed in
    ``dtype``; also the rank map of every level."""
    levels = pyramid(img.to(dtype), orb)
    budgets = level_budgets(orb)
    ranks, xys, lvls, descs, masks = [], [], [], [], []
    for lv, level_img in enumerate(levels):
        rank = rank_map(level_img, orb)
        ranks.append(rank)
        w = level_img.shape[1]
        k_l = int(budgets[lv])
        vals, idx = torch.sort(rank.reshape(-1), descending=True, stable=True)
        vals, idx = vals[:k_l], idx[:k_l]
        # positions are indices, float32 whatever ``dtype`` is
        xy_int = torch.stack([(idx % w).float(), (idx // w).float()], -1)
        patches = _patches(level_img, xy_int, PATCH_RADIUS + 2)
        angles = _orientation(patches)
        smooth = _box_sum_shifts(patches, 2) / 25.0
        xys.append(xy_int * (orb.scale_factor ** lv))
        lvls.append(torch.full((k_l,), lv, dtype=torch.int64,
                               device=img.device))
        descs.append(_descriptors(smooth, angles))
        masks.append(torch.isfinite(vals))
    return Features(torch.cat(xys), torch.cat(lvls), torch.cat(descs),
                    torch.cat(masks)), ranks
