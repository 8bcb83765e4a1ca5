"""Front-end data types: frames and id generation (port of
``mvslam_tpu.frontend.data_types``). A frame is an immutable host object
holding tensors on one device; the heavy per-frame state is the
:class:`mvslam_tpu_torch.ops.features.FeatureSet`."""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Optional

import torch

from mvslam_tpu_torch.ops.camera import PinholeCamera
from mvslam_tpu_torch.ops.features import FeatureSet

Tensor = torch.Tensor

INVALID_ID = -1

_id_counter = itertools.count()
_id_lock = threading.Lock()


def generate_frame_id() -> int:
    """Monotonic unique frame id (an atomic counter)."""
    with _id_lock:
        return next(_id_counter)


@dataclass(frozen=True)
class Frame:
    """One captured frame."""

    id: int
    capture_time: float
    features: FeatureSet
    rays: Tensor                     # (K, 3) ideal-camera homogeneous rays
    sigma: Tensor                    # (K,) measurement stddev in ideal units
    focal: float = 1.0               # sqrt(fx * fy): pixel <-> ideal scale
    camera: Optional[PinholeCamera] = field(default=None, repr=False)
    image: Optional[Tensor] = field(default=None, repr=False)
    image_smooth: Optional[Tensor] = field(default=None, repr=False)  # for KLT
