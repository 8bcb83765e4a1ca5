"""ORB-style feature detection + description (port of
``mvslam_tpu.ops.features``, per-level unrolled layout).

Per pyramid level: the dense corner front (FAST-9/16 max-margin score,
strict 3x3 NMS, border suppression, Harris rank) runs through
:func:`mvslam_tpu_torch.ops.features_cuda.fast_nms_harris_rank` — the
hand-written CUDA kernel on the card, the plain composition here on the
CPU — then a stable top-k per level, a patch gather, intensity-centroid
orientation and 256-bit rBRIEF descriptors.

Descriptors are ``(K, 8)`` int32 words holding the same bits as the JAX
package's uint32 words (``torch.uint32`` supports few operations).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

#: FAST-9/16 Bresenham circle, circular order (dx, dy)
_FAST_CIRCLE = (
    (3, 0), (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3), (1, -3), (2, -2),
    (3, -1),
)

PATCH_RADIUS = 15            # orientation disc + descriptor patch half-size
DESCRIPTOR_BITS = 256
_PATTERN_SCALE = PATCH_RADIUS / 3.0


def _brief_pattern() -> np.ndarray:
    """Deterministic rBRIEF sampling pattern: 256 pairs of (x, y) offsets,
    Gaussian around the patch center, clipped to the disc. The same seeded
    numpy recipe as the JAX package, so both describe identically."""
    rng = np.random.default_rng(0x0B5E55ED)
    pts = rng.normal(0.0, _PATTERN_SCALE, size=(DESCRIPTOR_BITS, 2, 2))
    r = PATCH_RADIUS - 2
    return np.clip(pts, -r, r).astype(np.float32)


_PATTERN = _brief_pattern()   # (256, 2, 2)


class FeatureSet(NamedTuple):
    """Fixed-capacity keypoints + descriptors for one image: ``xy`` (K, 2)
    level-0 pixels, ``response`` Harris, ``angle`` radians, ``octave``,
    ``sigma`` per-keypoint stddev, ``desc`` (K, 8) int32 words, ``mask``."""

    xy: Tensor
    response: Tensor
    angle: Tensor
    octave: Tensor
    sigma: Tensor
    desc: Tensor
    mask: Tensor


class OrbParams(NamedTuple):
    max_features: int = 512
    fast_threshold: float = 20.0 / 255.0   # OpenCV default 20 (8-bit)
    harris_k: float = 0.04
    num_levels: int = 8
    scale_factor: float = 1.2
    border: int = PATCH_RADIUS + 4         # keep descriptor patches inside
    # not ported yet (see ROADMAP): both raise NotImplementedError
    subpixel: bool = False
    batched: bool = False


def _pad_hw(img: Tensor, pad: int, mode: str = "constant",
            value: float = 0.0) -> Tensor:
    """Pad the trailing two (H, W) axes of an (..., H, W) tensor."""
    if mode == "constant":
        return F.pad(img, (pad, pad, pad, pad), value=value)
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + img.shape[-2:])
    x = F.pad(x, (pad, pad, pad, pad), mode=mode)
    return x.reshape(lead + x.shape[-2:])


def _window(p: Tensor, pad: int, dx: int, dy: int, shape) -> Tensor:
    H, W = shape[-2:]
    return p[..., pad + dy: pad + dy + H, pad + dx: pad + dx + W]


def _shift0(img: Tensor, dx: int, dy: int) -> Tensor:
    """out[y, x] = img[y + dy, x + dx], zero fill (|dx|, |dy| <= 1)."""
    return _window(_pad_hw(img, 1), 1, dx, dy, img.shape)


def sep_filter3(img: Tensor, kv, kh) -> Tensor:
    """Separable 3-tap cross-correlation (vertical taps ``kv`` then
    horizontal ``kh``), zero-padded, in the JAX package's add order."""
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
    """Max-margin FAST-9/16 corner score per pixel (0 = not a corner): the
    best, over the 16 circular 9-long arcs, of the worst margin in the arc
    (``ring - center - t`` bright, ``center - ring - t`` dark). Edge-
    replicated ring reads."""
    p = _pad_hw(img, 3, mode="replicate")
    ring = torch.stack([_window(p, 3, dx, dy, img.shape)
                        for dx, dy in _FAST_CIRCLE])          # (16, H, W)
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
    """Keep strict local maxima of a 3x3 neighborhood."""
    p = _pad_hw(score, 1, value=-math.inf)
    nbr = torch.stack([_window(p, 1, dx, dy, score.shape)
                       for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                       if not (dx == 0 and dy == 0)])
    return torch.where(score >= torch.amax(nbr, dim=0), score,
                       torch.zeros_like(score))


def _box_sum(img: Tensor, radius: int) -> Tensor:
    """Same-size centered (2r+1)^2 box filter via separable
    cumsum-difference passes (zero padding outside)."""
    k = 2 * radius + 1

    def win(x, dim):
        c = torch.cumsum(x, dim=dim)
        c = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c], dim=dim)
        n = c.shape[dim]
        return c.narrow(dim, k, n - k) - c.narrow(dim, 0, n - k)

    p = _pad_hw(img, radius)
    return win(win(p, img.dim() - 2), img.dim() - 1)


def _box_sum_shifts(img: Tensor, radius: int) -> Tensor:
    """Same-size centered box sum via separable shifted adds (zero fill),
    in the JAX package's add order."""

    def axis_sum(x, dim):
        pad = [0, 0] * (x.dim() - 1 - dim) + [radius, radius]
        p = F.pad(x, pad)
        out = x * 0
        for o in range(2 * radius + 1):
            out = out + p.narrow(dim, o, x.shape[dim])
        return out

    return axis_sum(axis_sum(img, img.dim() - 2), img.dim() - 1)


def harris_response(img: Tensor, k: float = 0.04,
                    block_radius: int = 3) -> Tensor:
    """Harris response ``det - k tr^2`` from separable Sobel gradients and
    box-summed structure tensor (ORB's HARRIS_SCORE ranking)."""
    smooth = (0.125, 0.25, 0.125)
    diff = (-1.0, 0.0, 1.0)
    Ix = sep_filter3(img, smooth, diff)
    Iy = sep_filter3(img, diff, smooth)
    Sxx = _box_sum(Ix * Ix, block_radius)
    Syy = _box_sum(Iy * Iy, block_radius)
    Sxy = _box_sum(Ix * Iy, block_radius)
    det = Sxx * Syy - Sxy * Sxy
    tr = Sxx + Syy
    return det - k * tr * tr


def _suppress_border(score: Tensor, border: int) -> Tensor:
    H, W = score.shape
    y = torch.arange(H, device=score.device)[:, None]
    x = torch.arange(W, device=score.device)[None, :]
    ok = (y >= border) & (y < H - border) & (x >= border) & (x < W - border)
    return torch.where(ok, score, torch.zeros_like(score))


def top_k(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Largest ``k`` of a 1-D tensor, lower index first on ties (the
    ``jax.lax.top_k`` order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _orientation(patches: Tensor) -> Tensor:
    """Intensity-centroid angle per patch (K, P, P) -> (K,), radians."""
    P = patches.shape[-1]
    c = (P - 1) / 2.0
    ar = torch.arange(P, dtype=patches.dtype, device=patches.device)
    yy = ar[:, None] - c
    xx = ar[None, :] - c
    disc = ((yy ** 2 + xx ** 2) <= PATCH_RADIUS ** 2).to(patches.dtype)
    m10 = torch.sum(patches * (xx * disc)[None], dim=(-2, -1))
    m01 = torch.sum(patches * (yy * disc)[None], dim=(-2, -1))
    return torch.atan2(m01, m10)


def _pack_words(bits: Tensor) -> Tensor:
    """(K, 256) bool -> (K, 8) int32 words (bit j of word w = bit 32w+j),
    the two's-complement view of the JAX package's uint32 words."""
    K = bits.shape[0]
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << \
        torch.arange(32, device=bits.device)
    words = torch.sum(bits.reshape(K, 8, 32).to(torch.int64) * weights, dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def _descriptors(patches_smooth: Tensor, angles: Tensor) -> Tensor:
    """Rotated-BRIEF bits from smoothed patches (K, P, P) -> (K, 8) int32.

    Plain index gather of the rotated pattern points (the JAX package's
    one-hot contractions select exactly these values)."""
    K, P = patches_smooth.shape[0], patches_smooth.shape[-1]
    c = (P - 1) / 2.0
    pat = torch.as_tensor(_PATTERN, dtype=patches_smooth.dtype,
                          device=patches_smooth.device)
    cos = torch.cos(angles)[:, None, None]
    sin = torch.sin(angles)[:, None, None]
    x = pat[None, ..., 0]
    y = pat[None, ..., 1]
    xr = cos * x - sin * y
    yr = sin * x + cos * y
    xi = torch.clamp(torch.round(xr + c), 0, P - 1).to(torch.int64)
    yi = torch.clamp(torch.round(yr + c), 0, P - 1).to(torch.int64)
    kk = torch.arange(K, device=patches_smooth.device)[:, None, None]
    samples = patches_smooth[kk, yi, xi]                     # (K, 256, 2)
    return _pack_words(samples[..., 0] < samples[..., 1])


def extract_patches(img: Tensor, xy: Tensor, radius: int) -> Tensor:
    """(K, P, P) patches centered at integer-rounded ``xy`` (edge-padded),
    by a plain index gather."""
    P = 2 * radius + 1
    H, W = img.shape
    padded = _pad_hw(img, radius, mode="replicate")
    x0 = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, W - 1)
    y0 = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, H - 1)
    off = torch.arange(P, device=img.device)
    rows = (y0[:, None] + off[None, :])[:, :, None]
    cols = (x0[:, None] + off[None, :])[:, None, :]
    return padded[rows, cols]


def _level_shapes(H: int, W: int, params: OrbParams) -> list[tuple[int, int]]:
    """Static per-level (h, w) of the scale pyramid."""
    shapes = [(H, W)]
    inv = 1.0 / params.scale_factor
    for _ in range(1, params.num_levels):
        h, w = shapes[-1]
        shapes.append((
            max(int(round(h * inv)), 2 * params.border + 1),
            max(int(round(w * inv)), 2 * params.border + 1),
        ))
    return shapes


def _level_budgets(params: OrbParams) -> np.ndarray:
    """Per-level keypoint budgets ~ geometric series (OpenCV allocation)."""
    L = params.num_levels
    inv = 1.0 / params.scale_factor
    raw = np.array([inv ** (2 * l) for l in range(L)])
    budgets = np.maximum(
        (params.max_features * raw / raw.sum()).astype(int), 1
    )
    budgets[0] += params.max_features - budgets.sum()
    return budgets


def resize_level(img: Tensor, shape: tuple[int, int]) -> Tensor:
    """Antialiased bilinear resize — ``jax.image.resize(..., "linear")``
    (which antialiases on downscale); half-pixel centers."""
    out = F.interpolate(img[None, None], size=shape, mode="bilinear",
                        align_corners=False, antialias=True)
    return out[0, 0]


def orb_detect(img: Tensor, params: OrbParams = OrbParams()) -> FeatureSet:
    """Detect + describe up to ``params.max_features`` keypoints.

    ``img``: (H, W) float32 grayscale in [0, 1]. Per-level budgets are
    proportional to level area, as in OpenCV ORB.
    """
    from mvslam_tpu_torch.ops.features_cuda import fast_nms_harris_rank

    if params.batched or params.subpixel:
        raise NotImplementedError(
            "OrbParams.batched / subpixel are not ported yet")
    dtype, dev = img.dtype, img.device
    H, W = img.shape
    L = params.num_levels
    shapes = _level_shapes(H, W, params)
    budgets = _level_budgets(params)

    parts = []
    level_img = img
    for l in range(L):
        w = level_img.shape[1]
        k_l = int(budgets[l])
        rank = fast_nms_harris_rank(level_img, params.fast_threshold,
                                    params.harris_k, params.border)
        vals, idx = top_k(rank.reshape(-1), k_l)
        xy_int = torch.stack([(idx % w).to(dtype), (idx // w).to(dtype)],
                             dim=-1)
        valid = torch.isfinite(vals)
        patches = extract_patches(level_img, xy_int, PATCH_RADIUS + 2)
        angles = _orientation(patches)
        smooth = _box_sum_shifts(patches, 2) / 25.0
        parts.append(FeatureSet(
            xy=xy_int * (params.scale_factor ** l),
            response=torch.where(valid, vals, torch.full_like(vals, -math.inf)),
            angle=angles,
            octave=torch.full((k_l,), l, dtype=torch.int32, device=dev),
            sigma=torch.full((k_l,), (2.0 ** l) * 0.5, dtype=dtype, device=dev),
            desc=_descriptors(smooth, angles),
            mask=valid,
        ))
        if l + 1 < L:
            level_img = resize_level(level_img, shapes[l + 1])
    return FeatureSet(*(torch.cat(field) for field in zip(*parts)))
