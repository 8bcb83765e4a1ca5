"""The dense ORB corner front as one hand-written CUDA kernel (port of
``mvslam_tpu.ops.features_pallas``).

The rank map of a pyramid level is ``where(suppress(nms(fast(img))) > 0,
harris(img), -inf)``. :func:`fast_nms_harris_rank_pyramid` computes the
maps of all levels of one frame's pyramid (:func:`fast_nms_harris_rank_flat`
the same maps as one flat buffer), :func:`fast_nms_harris_rank` that of one
level (the counterpart of the JAX function of that name):

- on CUDA tensors both launch ``csrc/fast_nms_harris.cu`` once (built with
  ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at first use, rebuilt
  when the source changes) and raise if the build or the launch fails;
- on CPU tensors they run :func:`fast_nms_harris_rank_ref`, the plain
  torch composition of ``ops.features``, level by level.

The kernel's corner set is bit-exact against the plain version; Harris
values differ by summation order only (see the source's header).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Sequence

import torch

from mvslam_tpu_torch.ops import features
from mvslam_tpu_torch.utils.cuda_build import CSRC, build_library

Tensor = torch.Tensor

_SOURCE = CSRC / "fast_nms_harris.cu"
#: nearest image border the kernel's clamp-to-edge halo matches exactly
MIN_BORDER = 4

#: most levels one launch takes (the size of the kernel's level table)
MAX_LEVELS = 16
#: the kernel's output tile (w, h), the source's TILE_W x TILE_H; the grid
#: is counted in these
TILE = (32, 16)

_lib = None


def fast_nms_harris_rank_ref(img: Tensor, threshold: float, k: float,
                             border: int) -> Tensor:
    """Plain torch composition of the corner front (the JAX package's
    unfused ``features.py`` path)."""
    score = features.fast_score(img, threshold)
    score = features.nms3x3(score)
    score = features._suppress_border(score, border)
    harris = features.harris_response(img, k)
    return torch.where(score > 0, harris, torch.full_like(harris, -math.inf))


class LevelTable(NamedTuple):
    """Where each level of a pyramid lies in one launch: ``offsets[l]`` is
    the first pixel of level ``l`` in the dense output, ``tile_first[l]``
    its first block in the one-dimensional grid."""

    offsets: tuple[int, ...]
    tile_first: tuple[int, ...]
    total_pixels: int
    total_tiles: int


def level_table(shapes: Sequence[tuple[int, int]]) -> LevelTable:
    """Output offsets and tile prefixes of the levels ``shapes`` (each
    ``(h, w)``), in the order given."""
    tile_w, tile_h = TILE
    offsets, tile_first = [], []
    pixels = tiles = 0
    for h, w in shapes:
        offsets.append(pixels)
        tile_first.append(tiles)
        pixels += h * w
        tiles += -(-h // tile_h) * -(-w // tile_w)
    return LevelTable(tuple(offsets), tuple(tile_first), pixels, tiles)


@functools.lru_cache(maxsize=64)
def _c_level_table(shapes: tuple[tuple[int, int], ...]):
    """``level_table`` plus its host arrays in the C entry point's types."""
    tab = level_table(shapes)
    if tab.total_pixels >= 2 ** 31:
        raise ValueError(f"pyramid of {tab.total_pixels} pixels is too large")
    ints = ctypes.c_int * len(shapes)
    return (tab, ints(*(h for h, _ in shapes)), ints(*(w for _, w in shapes)),
            ints(*tab.offsets), ints(*tab.tile_first))


def load_library() -> ctypes.CDLL:
    """Build the kernel (``utils.cuda_build.build_library``) and load it;
    idempotent."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build_library(_SOURCE)
    lib.mvslam_fast_nms_harris_rank_pyramid.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.mvslam_fast_nms_harris_rank_pyramid.restype = ctypes.c_int
    lib.mvslam_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mvslam_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return _lib


def _check_levels(levels: Sequence[Tensor], border: int) -> None:
    """Raise ``ValueError`` on what the kernel does not take."""
    if border < MIN_BORDER:
        raise ValueError(f"border must be >= {MIN_BORDER}, got {border}")
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"one launch takes 1 to {MAX_LEVELS} levels, got "
                         f"{len(levels)}")
    for lv in levels:
        if (lv.dtype != torch.float32 or lv.dim() != 2 or lv.numel() == 0
                or not lv.is_contiguous()):
            raise ValueError("a level is a non-empty contiguous 2-D float32 "
                             f"tensor, got {lv.dtype} {tuple(lv.shape)} "
                             f"strides {lv.stride()}")
        if lv.device != levels[0].device:
            raise ValueError(f"levels on {levels[0].device} and {lv.device}")
    if levels[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {levels[0].device}")


def fast_nms_harris_rank_flat(levels: Sequence[Tensor], threshold: float,
                              k: float, border: int) -> Tensor:
    """Rank maps of all levels of one pyramid, level after level (each
    row-major) in one flat float32 tensor of ``sum(h * w)`` entries: Harris
    where a FAST corner survives strict 3x3 NMS and the border, -inf
    elsewhere.

    ``levels``: up to ``MAX_LEVELS`` contiguous (h, w) float32 images in
    [0, 1] on one device. CUDA tensors take one kernel launch for all
    levels, on the current stream (no fallback); CPU tensors run the plain
    composition per level.
    """
    levels = list(levels)
    _check_levels(levels, border)
    if levels[0].device.type == "cpu":
        return torch.cat([fast_nms_harris_rank_ref(lv, threshold, k,
                                                   border).reshape(-1)
                          for lv in levels])
    lib = load_library()
    shapes = tuple((lv.shape[0], lv.shape[1]) for lv in levels)
    tab, c_h, c_w, c_off, c_tile = _c_level_table(shapes)
    dev = levels[0].device
    out = torch.empty(tab.total_pixels, dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * len(levels))(*(lv.data_ptr() for lv in levels))
    with torch.cuda.device(dev):
        err = lib.mvslam_fast_nms_harris_rank_pyramid(
            len(levels), ptrs, out.data_ptr(), c_h, c_w, c_off, c_tile,
            tab.total_tiles, float(threshold), float(k), int(border),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("fast_nms_harris_rank_pyramid launch failed: "
                           + lib.mvslam_cuda_error_string(err).decode())
    fast_nms_harris_rank_pyramid.launches += 1
    return out


def fast_nms_harris_rank_pyramid(levels: Sequence[Tensor], threshold: float,
                                 k: float, border: int) -> list[Tensor]:
    """Rank maps of all levels of one pyramid, as dense (h, w) views of
    :func:`fast_nms_harris_rank_flat`'s one buffer (one kernel launch on
    CUDA tensors, the plain composition per level on CPU tensors)."""
    levels = list(levels)
    flat = fast_nms_harris_rank_flat(levels, threshold, k, border)
    shapes = [(lv.shape[0], lv.shape[1]) for lv in levels]
    # one view op per level (a slice and a reshape would be two)
    return [flat.as_strided((h, w), (w, 1), o)
            for o, (h, w) in zip(level_table(shapes).offsets, shapes)]


#: kernel launches since import (or since a caller reset it), whichever
#: wrapper made them (all launch in ``fast_nms_harris_rank_flat``)
fast_nms_harris_rank_pyramid.launches = 0


def fast_nms_harris_rank(img: Tensor, threshold: float, k: float,
                         border: int) -> Tensor:
    """Rank map of one (h, w) float32 level: a one-level call of
    :func:`fast_nms_harris_rank_pyramid`, counted in its ``launches``."""
    return fast_nms_harris_rank_pyramid([img], threshold, k, border)[0]
