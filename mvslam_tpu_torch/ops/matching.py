"""Descriptor matching: brute-force Hamming kNN(2) + Lowe ratio (port of
``mvslam_tpu.ops.matching``).

For 256-bit descriptors with bit vectors ``s = 2 bit - 1 in {-1, +1}``,
``hamming(a, b) = (256 - s_a . s_b) / 2``: one float32 matmul whose every
partial sum is an integer of magnitude <= 256, hence exact in any
summation order (and under TF32, whose inputs +-1 are exact too).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor

BITS = 256
LOWE_RATIO = 0.7
INVALID_DIST = BITS + 1


class MatchResult(NamedTuple):
    """Per-query best matches (length K1): ``idx`` best train index,
    ``dist`` its Hamming distance, ``mask`` passed all gates."""

    idx: Tensor
    dist: Tensor
    mask: Tensor
    second_dist: Tensor


def unpack_pm1(desc: Tensor) -> Tensor:
    """(K, 8) int32 words -> (K, 256) float32 in {-1, +1}."""
    shifts = torch.arange(32, device=desc.device)
    bits = (desc.to(torch.int64)[..., :, None] >> shifts) & 1
    return (2 * bits.reshape(desc.shape[0], BITS) - 1).to(torch.float32)


def hamming_matrix(desc1: Tensor, desc2: Tensor) -> Tensor:
    """All-pairs Hamming distances (K1, K2) int32."""
    dots = unpack_pm1(desc1) @ unpack_pm1(desc2).T
    return ((BITS - dots) * 0.5).to(torch.int32)


def match_features(desc1: Tensor, mask1: Tensor, desc2: Tensor,
                   mask2: Tensor, max_distance: int | None = None,
                   ratio: float = LOWE_RATIO) -> MatchResult:
    """kNN(2) + Lowe ratio matching of query set 1 against train set 2:
    keep a match when ``d1 < ratio * d2`` and ``d1 <= max_distance``.
    Top-2 by a stable sort: lower train index first on ties, as
    ``jax.lax.top_k``."""
    D = hamming_matrix(desc1, desc2)
    D = torch.where(mask2[None, :], D, torch.full_like(D, INVALID_DIST))
    top, idx = torch.sort(D, dim=1, stable=True)
    d1, d2 = top[:, 0], top[:, 1]
    best = idx[:, 0]
    ok = mask1 & (d1 < ratio * d2) & (d1 <= BITS)
    if max_distance is not None:
        ok = ok & (d1 <= max_distance)
    return MatchResult(idx=best, dist=d1, mask=ok, second_dist=d2)
