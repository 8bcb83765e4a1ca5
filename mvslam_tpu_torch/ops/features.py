"""ORB-style feature detection + description (port of
``mvslam_tpu.ops.features``).

The scale pyramid is built first; the dense corner front (FAST-9/16
max-margin score, strict 3x3 NMS, border suppression, Harris rank) of all
its levels then runs through one call of the corner kernel
(:mod:`mvslam_tpu_torch.ops.features_cuda`) — one launch of the
hand-written CUDA kernel on the card, the plain composition per level on
the CPU — in both layouts of ``OrbParams.batched``. The per-keypoint half
(stable top-k, patch gather, intensity-centroid orientation, 256-bit
rBRIEF descriptors) runs level by level (unrolled, the default) or once
over an ``(L, H, W)`` canvas of the levels (batched); both give the same
features. ``OrbParams.subpixel`` fits a parabola on each kept corner's
Harris neighbourhood. ``orb_detect`` is the pyramid, the kernel's call
(``corner_ranks``) and the per-keypoint half (``orb_keypoints``), which
reads nothing on the host.

Descriptors are ``(K, 8)`` int32 words holding the same bits as the JAX
package's uint32 words (``torch.uint32`` supports few operations).
"""

from __future__ import annotations

import functools
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

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


class OrbParams(NamedTuple):
    max_features: int = 512
    fast_threshold: float = 20.0 / 255.0   # OpenCV default 20 (8-bit)
    harris_k: float = 0.04
    num_levels: int = 8
    scale_factor: float = 1.2
    border: int = PATCH_RADIUS + 4         # keep descriptor patches inside
    # Harris-surface sub-pixel localization (off by default: integer anchors
    # are deterministic across frames; KLT refines geometry instead)
    subpixel: bool = False
    # layout of the per-keypoint half: level by level (False) or once over
    # one (L, H, W) canvas of the levels (True); the same features
    batched: bool = False
    # the JAX package's switches for its Pallas kernel, accepted so that its
    # OrbParams carries over field for field; they select nothing here: a
    # CUDA tensor always takes the CUDA kernel, a CPU tensor its plain
    # version
    pallas_dense: bool = False
    pallas_interpret: bool = False


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


@functools.lru_cache(maxsize=16)
def _device_pattern(device: torch.device, dtype: torch.dtype) -> Tensor:
    """``_PATTERN`` on ``device`` in ``dtype``, built once per pair: a
    frame's descriptors then upload nothing (an upload from pageable
    memory reads on the host and cannot be captured in a CUDA graph)."""
    return torch.as_tensor(_PATTERN, dtype=dtype, device=device)


def _descriptors(patches_smooth: Tensor, angles: Tensor) -> Tensor:
    """Rotated-BRIEF bits from smoothed patches (K, P, P) -> (K, 8) int32.

    Plain index gather of the rotated pattern points (the JAX package's
    one-hot contractions select exactly these values)."""
    K, P = patches_smooth.shape[0], patches_smooth.shape[-1]
    c = (P - 1) / 2.0
    pat = _device_pattern(patches_smooth.device, patches_smooth.dtype)
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


def _extract_patches_lhw(canvas: Tensor, lev: Tensor, xy: Tensor,
                         radius: int) -> Tensor:
    """(K, P, P) patches from an (L, H, W) level canvas: keypoint ``k`` at
    the integer-rounded level-local ``xy[k]`` of level ``lev[k]``, zero
    outside the canvas (kept keypoints lie >= border from their level's
    edges, so their patches never reach it). One gather for all levels."""
    P = 2 * radius + 1
    H, W = canvas.shape[-2:]
    padded = _pad_hw(canvas, radius)
    x0 = torch.clamp(torch.round(xy[:, 0]).to(torch.int64), 0, W - 1)
    y0 = torch.clamp(torch.round(xy[:, 1]).to(torch.int64), 0, H - 1)
    off = torch.arange(P, device=canvas.device)
    rows = (y0[:, None] + off[None, :])[:, :, None]
    cols = (x0[:, None] + off[None, :])[:, None, :]
    return padded[lev[:, None, None], rows, cols]


def _parabolic_offset(sm: Tensor, s0: Tensor, sp: Tensor) -> Tensor:
    """1D quadratic-fit subpixel offset, trusted only at true 1D maxima
    (the rank maximizes Harris among FAST corners, so a plain neighbour can
    be larger: fitting uphill just clamps)."""
    denom = 2.0 * (2.0 * s0 - sm - sp)
    off = (sp - sm) / torch.where(torch.abs(denom) < torch.finfo(s0.dtype).eps,
                                  torch.ones_like(denom), denom)
    is_max = (s0 >= sm) & (s0 >= sp)
    return torch.where(is_max, torch.clamp(off, -0.5, 0.5),
                       torch.zeros_like(off))


#: dtype of the Harris surface the subpixel fit reads. Its 7x7 box sums are
#: cumsum differences, and running sums kept in float32 (XLA; torch on the
#: card) round enough to move an offset by up to 4e-4 px (XLA against
#: torch's CPU sums, which accumulate in float64, on a 480x640 frame); in
#: float64 the card and the CPU agree
_SUBPIXEL_DTYPE = torch.float64


def _subpixel_offset(nbhd: Tensor) -> Tensor:
    """(K, 2) offsets (dx, dy) from (K, 3, 3) Harris neighbourhoods."""
    dx = _parabolic_offset(nbhd[:, 1, 0], nbhd[:, 1, 1], nbhd[:, 1, 2])
    dy = _parabolic_offset(nbhd[:, 0, 1], nbhd[:, 1, 1], nbhd[:, 2, 1])
    return torch.stack([dx, dy], dim=-1)


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


def pyramid(img: Tensor, params: OrbParams = OrbParams()) -> list[Tensor]:
    """The scale pyramid of ``img``: level 0 is ``img`` itself, and each
    further level is resized from the one before it."""
    levels = [img]
    for shape in _level_shapes(img.shape[0], img.shape[1], params)[1:]:
        levels.append(resize_level(levels[-1], shape))
    return levels


def orb_detect(img: Tensor, params: OrbParams = OrbParams()) -> FeatureSet:
    """Detect + describe up to ``params.max_features`` keypoints.

    ``img``: (H, W) float32 grayscale in [0, 1]. Per-level budgets are
    proportional to level area, as in OpenCV ORB. Both layouts
    (``params.batched``) run the corner kernel once per image and give the
    same features; they differ in the ``xy`` of invalid slots only.
    """
    levels = pyramid(img, params)
    return orb_keypoints(levels, corner_ranks(levels, params), params)


def corner_ranks(levels: list[Tensor], params: OrbParams):
    """The corner kernel's one call over the pyramid ``levels``: the rank
    maps of the levels (``fast_nms_harris_rank_pyramid``) in the unrolled
    layout, their one flat buffer (``fast_nms_harris_rank_flat``) in the
    batched one. The function is looked up on ``features_cuda`` at each
    call, so that a wrapper put there sees every launch."""
    from mvslam_tpu_torch.ops import features_cuda

    args = (levels, params.fast_threshold, params.harris_k, params.border)
    if params.batched:
        return features_cuda.fast_nms_harris_rank_flat(*args)
    return features_cuda.fast_nms_harris_rank_pyramid(*args)


def orb_keypoints(levels: list[Tensor], ranks, params: OrbParams
                  ) -> FeatureSet:
    """The per-keypoint half of ``orb_detect``, from the pyramid and
    ``corner_ranks``' output: it reads nothing on the host."""
    if params.batched:
        return _batched_keypoints(levels, ranks, params)
    return _unrolled_keypoints(levels, ranks, params)


def _unrolled_keypoints(levels: list[Tensor], ranks: list[Tensor],
                        params: OrbParams) -> FeatureSet:
    """The per-keypoint half level by level, at each level's own size."""
    dtype, dev = levels[0].dtype, levels[0].device
    budgets = _level_budgets(params)
    parts = []
    for l, (level_img, rank) in enumerate(zip(levels, ranks)):
        w = level_img.shape[1]
        k_l = int(budgets[l])
        vals, idx = top_k(rank.reshape(-1), k_l)
        xy_int = torch.stack([(idx % w).to(dtype), (idx // w).to(dtype)],
                             dim=-1)
        valid = torch.isfinite(vals)
        xy_level = xy_int
        if params.subpixel:
            # the rank's corner set is the kernel's; the fit needs the raw
            # Harris surface around each corner, which the kernel does not
            # write: the plain response of the level (see _SUBPIXEL_DTYPE)
            harris = harris_response(level_img.to(_SUBPIXEL_DTYPE),
                                     params.harris_k)
            xy_level = xy_int + _subpixel_offset(
                extract_patches(harris, xy_int, 1)).to(dtype)
        # descriptors sample at the stable integer position
        patches = extract_patches(level_img, xy_int, PATCH_RADIUS + 2)
        angles = _orientation(patches)
        smooth = _box_sum_shifts(patches, 2) / 25.0
        parts.append(FeatureSet(
            xy=xy_level * (params.scale_factor ** l),
            response=torch.where(valid, vals, torch.full_like(vals, -math.inf)),
            angle=angles,
            octave=torch.full((k_l,), l, dtype=torch.int32, device=dev),
            sigma=torch.full((k_l,), (2.0 ** l) * 0.5, dtype=dtype, device=dev),
            desc=_descriptors(smooth, angles),
            mask=valid,
        ))
    return FeatureSet(*(torch.cat(field) for field in zip(*parts)))


class _CanvasLayout(NamedTuple):
    """Static maps of the batched layout for one pyramid shape."""

    dst: Tensor         # (sum h*w,) each level pixel's place in the canvas
    lev: Tensor         # (K,) level of each keypoint slot
    rnk: Tensor         # (K,) rank of each slot within its level
    octave: Tensor      # (K,) int32
    scale: Tensor       # (K,) scale_factor ** level
    sigma: Tensor       # (K,) 2 ** level * 0.5


@functools.lru_cache(maxsize=16)
def _canvas_layout(shapes: tuple[tuple[int, int], ...],
                   budgets: tuple[int, ...], scale_factor: float,
                   device: torch.device, dtype: torch.dtype) -> _CanvasLayout:
    """Built once per pyramid shape and device: the frame's calls then
    upload nothing."""
    H, W = shapes[0]
    dst = np.concatenate([
        l * H * W + (np.arange(h)[:, None] * W + np.arange(w)[None, :]).ravel()
        for l, (h, w) in enumerate(shapes)])
    slot_level = np.repeat(np.arange(len(shapes)), budgets)
    slot_rank = np.concatenate([np.arange(n) for n in budgets])

    def dev(a, dt):
        return torch.as_tensor(a, dtype=dt, device=device)

    return _CanvasLayout(
        dst=dev(dst, torch.int64), lev=dev(slot_level, torch.int64),
        rnk=dev(slot_rank, torch.int64), octave=dev(slot_level, torch.int32),
        scale=dev(scale_factor ** slot_level.astype(np.float64), dtype),
        sigma=dev(2.0 ** slot_level.astype(np.float64) * 0.5, dtype))


def _canvas(flat: Tensor, dst: Tensor, shape: tuple[int, int, int],
            fill: float) -> Tensor:
    """The levels held in ``flat`` (level after level, row-major) placed
    top-left in an (L, H, W) canvas filled with ``fill``: one scatter."""
    out = torch.full((shape[0] * shape[1] * shape[2],), fill,
                     dtype=flat.dtype, device=flat.device)
    return out.index_copy_(0, dst, flat).view(shape)


def _batched_keypoints(levels: list[Tensor], rank_flat: Tensor,
                       params: OrbParams) -> FeatureSet:
    """The per-keypoint half once over an (L, H, W) canvas (the JAX canvas
    layout). The ranks of the one kernel call are placed into a -inf canvas
    and the levels into a zero canvas; one stable descending sort per
    canvas row keeps ``jax.lax.top_k``'s tie order (canvas index
    ``y * W + x`` orders as ``y * w + x`` does within a level), a static
    slot map picks each level's budget, and one patch gather, orientation
    and descriptor pass serve all K keypoints."""
    dtype = levels[0].dtype
    H, W = levels[0].shape
    shape = (len(levels), H, W)
    lay = _canvas_layout(tuple((lv.shape[0], lv.shape[1]) for lv in levels),
                         tuple(int(b) for b in _level_budgets(params)),
                         params.scale_factor, levels[0].device, dtype)
    rank = _canvas(rank_flat, lay.dst, shape, -math.inf)
    canvas = _canvas(torch.cat([lv.reshape(-1) for lv in levels]), lay.dst,
                     shape, 0.0)
    vals_l, idx_l = torch.sort(rank.reshape(shape[0], H * W), dim=1,
                               descending=True, stable=True)
    vals = vals_l[lay.lev, lay.rnk]
    idx = idx_l[lay.lev, lay.rnk]
    xy_int = torch.stack([(idx % W).to(dtype), (idx // W).to(dtype)], dim=-1)
    valid = torch.isfinite(vals)
    xy_level = xy_int
    if params.subpixel:
        # Harris over the canvas, as the JAX canvas layout computes it: at a
        # level's pixels it sums the same values as the level's own response
        harris = harris_response(canvas.to(_SUBPIXEL_DTYPE), params.harris_k)
        xy_level = xy_int + _subpixel_offset(
            _extract_patches_lhw(harris, lay.lev, xy_int, 1)).to(dtype)
    # descriptors sample at the stable integer position
    patches = _extract_patches_lhw(canvas, lay.lev, xy_int, PATCH_RADIUS + 2)
    angles = _orientation(patches)
    smooth = _box_sum_shifts(patches, 2) / 25.0
    return FeatureSet(
        xy=xy_level * lay.scale[:, None],
        response=torch.where(valid, vals, torch.full_like(vals, -math.inf)),
        angle=angles, octave=lay.octave, sigma=lay.sigma,
        desc=_descriptors(smooth, angles), mask=valid)
