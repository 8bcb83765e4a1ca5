"""Small float32 matrix products on the CPU in a fixed summation order, the
same bits on every host.

The bottom eigenvalues of a near-degenerate 8-point DLT lie below ``eps32 *
trace``, so which eigenvectors the spectral solver returns follows the last
bits of its sums. A BLAS sums in an order of its own choosing: MKL's AVX-512
kernels sum the 8-point solver's Gram matrices and squarings as a chain of
fused multiply-adds over ``k`` in ascending order (XLA's CPU dot sums the
squarings the same way), its read-out as a chain of rounded products and
sums; on its AVX2 and compatibility paths it sums otherwise. These
functions compute those orders on any CPU:

- :func:`fma_matmul`: one rounding per step, from exact float64 products and
  a float64 sum corrected to round to odd;
- :func:`chain_matmul`: a rounded product, then a rounded sum.

On CUDA tensors, and for other dtypes than float32, both take ``a @ b``:
the card's product is cuBLAS's, one platform, held to the CPU within the
tolerances of ``chip_smoke.py``'s parity phases.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _fixed(a: Tensor, b: Tensor) -> bool:
    return (a.dtype == b.dtype == torch.float32 and a.device.type == "cpu"
            and b.device.type == "cpu")


def _fma(acc: Tensor, p: Tensor) -> Tensor:
    """``acc + p`` rounded once to float32, for float32 ``acc`` and an exact
    float64 product ``p``."""
    c = acc.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)             # s + err == p + c exactly
    # round to odd: a float64 sum that was rounded and landed on an even
    # significand moves one float64 ulp toward the exact sum, so the
    # float32 rounding below cannot round twice
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(err)
    return torch.where(fix, torch.nextafter(s, s + err), s).float()


def fma_matmul(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` for float32 (..., n, k) and (..., k, m) on the CPU, summed
    over k in ascending order by fused multiply-adds; ``a @ b`` otherwise.
    Leading dims broadcast."""
    if not _fixed(a, b):
        return a @ b
    a64, b64 = torch.broadcast_tensors(a.double()[..., :, :, None],
                                       b.double()[..., None, :, :])
    acc = torch.zeros(a64.shape[:-3] + (a64.shape[-3], a64.shape[-1]),
                      dtype=torch.float32)
    for q in range(a64.shape[-2]):
        acc = _fma(acc, a64[..., q, :] * b64[..., q, :])
    return acc


def chain_matmul(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` for float32 on the CPU, summed over k in ascending order,
    each product and each sum rounded; ``a @ b`` otherwise."""
    if not _fixed(a, b):
        return a @ b
    acc = a[..., :, 0, None] * b[..., None, 0, :]
    for q in range(1, a.shape[-1]):
        acc = acc + a[..., :, q, None] * b[..., None, q, :]
    return acc
