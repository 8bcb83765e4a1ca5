"""The H100's published peaks and K1's least time, for the roofline share
of ``fast_nms_harris_pyramid_kernel``: a frozen copy of the arithmetic of
``chip_smoke.py`` (``k1_bound``, ``compass_candidates``; PERF.md's 288x384
figures: 2,740,224 B at 3.35 TB/s, 38.7 MFLOP at 67 TFLOP/s).
"""

from __future__ import annotations

from typing import Sequence

import torch

#: one H100 SXM: HBM3 bytes/s, float32 operations/s outside the tensor
#: cores (NVIDIA's data sheet, at the 700 W limit)
H100_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
#: float32 operations of the corner front. Every pixel: the 4-pixel compass
#: test (4 x 2 margins of 2 ops, 8 compares), Sobel and the three products
#: (26), strict NMS and the border test (10). Every compass candidate: 32
#: margins of 2 ops, two arc searches of 64 min + 15 max, the final max.
#: Every corner inside the border: 3 x 49 adds and Harris (8).
FLOPS_PER_PIXEL = 24 + 26 + 10
FLOPS_PER_CANDIDATE = 64 + 2 * 79 + 2
FLOPS_PER_CORNER = 147 + 8


def compass_candidates(img: torch.Tensor, threshold: float) -> int:
    """Pixels whose FAST score can be non-zero: two of the four compass
    ring pixels brighter than c + t, or two darker than c - t."""
    c = img[3:-3, 3:-3]
    ring = torch.stack([img[3:-3, 6:], img[6:, 3:-3], img[3:-3, :-6],
                        img[:-6, 3:-3]])
    bright = (((ring - c) - threshold) > 0).sum(0)
    dark = (((c - ring) - threshold) > 0).sum(0)
    return int(((bright >= 2) | (dark >= 2)).sum())


def k1_bound(shapes: Sequence[tuple[int, int]], candidates: int,
             corners: int) -> dict:
    """Least seconds the card could take for the corner front of a pyramid
    of level ``shapes``: the larger of its bytes (each level read once, its
    rank map written once) over the memory rate and its float32 operations
    over the float32 rate."""
    pixels = sum(h * w for h, w in shapes)
    nbytes = pixels * (4 + 4)
    flops = (pixels * FLOPS_PER_PIXEL + candidates * FLOPS_PER_CANDIDATE
             + corners * FLOPS_PER_CORNER)
    s_bytes = nbytes / H100_BYTES_PER_S
    s_flops = flops / H100_F32_FLOPS
    return dict(pixels=pixels, bytes=nbytes, flops=flops,
                seconds=max(s_bytes, s_flops),
                bound_by="bytes" if s_bytes >= s_flops else "operations")
