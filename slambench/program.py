"""The system under test, ``mvslam_tpu_torch``, as the benchmark drives it:
the one module of ``slambench`` that imports the port. It builds the
tracker's step (``frontend/vo_jit.make_vo_step``), its two halves
(``make_vo_pipelined``) and its state from a configuration file's
overrides, and taps K1's rank maps on the frames the comparison reads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mvslam_tpu_torch.frontend import vo_jit
from mvslam_tpu_torch.ops import features_cuda
from mvslam_tpu_torch.ops.features import OrbParams

from slambench import reference

MODE_EMPTY = vo_jit.MODE_EMPTY
MODE_INITIALIZING = vo_jit.MODE_INITIALIZING
MODE_TRACKING = vo_jit.MODE_TRACKING
#: the profiler's name of K1, ``csrc/fast_nms_harris.cu``
K1_KERNEL = "fast_nms_harris"


def orb_settings(config: dict) -> dict:
    o = dict(config["orb"])
    o["fast_threshold"] = o.pop("fast_threshold_8bit") / 255.0
    return o


def vo_params(config: dict) -> vo_jit.VoJitParams:
    return vo_jit.VoJitParams(orb=OrbParams(**orb_settings(config)),
                              **config.get("vo", {}))


def reference_orb(config: dict) -> reference.Orb:
    """The same detector settings for the plain reference."""
    p = vo_params(config).orb
    return reference.Orb(p.max_features, p.fast_threshold, p.harris_k,
                         p.num_levels, p.scale_factor, p.border)


class Tracker(NamedTuple):
    params: vo_jit.VoJitParams
    step: object            # step(state, image, K_inv, focal)
    pre: object             # pre(image, K_inv, focal)
    combine: object         # combine(state, frame_arrays, smooth, K_inv, focal)
    K_inv: torch.Tensor
    focal: torch.Tensor
    device: torch.device

    def init_state(self, seed: int):
        return vo_jit.vo_init_state(self.params, device=self.device,
                                    seed=seed)


def tracker(config: dict, K: np.ndarray, device) -> Tracker:
    params = vo_params(config)
    dev = torch.device(device)
    pre, combine = vo_jit.make_vo_pipelined(params)
    return Tracker(params, vo_jit.make_vo_step(params), pre, combine,
                   torch.tensor(np.linalg.inv(K), dtype=torch.float32,
                                device=dev),
                   torch.tensor(K[0, 0], dtype=torch.float32, device=dev),
                   dev)


class K1Tap:
    """Keeps the rank maps K1 returned on the frames asked for: a wrapper
    around ``features_cuda.fast_nms_harris_rank_pyramid`` that holds a
    reference to its output while ``want`` is set. The kernel's launch
    counter stays on the name the module's code increments."""

    def __init__(self):
        self.want = False
        self.got = None
        self._orig = None

    def install(self) -> None:
        orig = self._orig = features_cuda.fast_nms_harris_rank_pyramid

        def tapped(levels, *args, **kwargs):
            out = orig(levels, *args, **kwargs)
            if self.want:
                self.got = out
            return out

        tapped.launches = orig.launches
        features_cuda.fast_nms_harris_rank_pyramid = tapped

    def remove(self) -> None:
        if self._orig is not None:
            self._orig.launches = features_cuda.fast_nms_harris_rank_pyramid \
                .launches
            features_cuda.fast_nms_harris_rank_pyramid = self._orig
            self._orig = None
