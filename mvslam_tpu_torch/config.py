"""Numeric constants and dtype policy (the subset of ``mvslam_tpu.config``
the tracker uses). Constants resolve from the dtype of the data flowing
through: float64 in the oracle tests, float32 on the device."""

from __future__ import annotations

import torch

#: default compute dtype on device
DEFAULT_DTYPE = torch.float32


def epsilon(dtype: torch.dtype = DEFAULT_DTYPE) -> float:
    """Smallest meaningful magnitude (machine epsilon of ``dtype``)."""
    return float(torch.finfo(dtype).eps)


def taylor_threshold(dtype: torch.dtype = DEFAULT_DTYPE) -> float:
    """Angle below which Lie-group trig is Taylor-expanded (1e-5 for
    float64, scaled to 1e-3 for float32)."""
    return 1e-5 if dtype == torch.float64 else 1e-3
