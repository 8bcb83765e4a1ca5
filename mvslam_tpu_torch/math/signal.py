"""Signal processing: first-order IIR low-pass filter, ``y += alpha * (x -
y)`` (port of ``mvslam_tpu.math.signal``), as one step and over a sequence.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def lpf_update(y: Tensor, x: Tensor, alpha: float) -> Tensor:
    """One low-pass filter step."""
    return y + alpha * (x - y)


def lpf_scan(y0: Tensor, xs: Tensor, alpha: float) -> Tensor:
    """Filter a whole sequence (leading axis = time): a loop over that
    axis, every step on the inputs' device."""
    ys = []
    y = y0
    for x in xs:
        y = lpf_update(y, x, alpha)
        ys.append(y)
    if not ys:
        return xs.new_zeros((0,) + tuple(torch.as_tensor(y0).shape))
    return torch.stack(ys)


def constrain(x: Tensor, lo, hi) -> Tensor:
    """Clamp."""
    return torch.clamp(x, lo, hi)


def sqr(x):
    """Square."""
    return x * x
