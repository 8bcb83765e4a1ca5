"""The PyTorch port's CUDA kernel on the card: kernel against its plain
version at the tracker's pyramid shapes, the wrapper's checks and launch
count, and one tracker step on the device. Every test needs a CUDA card
and skips without one; this file imports no JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mvslam_tpu_torch.frontend.vo_jit import (
    VoJitParams, make_vo_step, vo_init_state,
)
from mvslam_tpu_torch.ops import features, features_cuda
from mvslam_tpu_torch.utils.scene import render_planes_sequence

pytestmark = pytest.mark.cuda

P = features.OrbParams()
#: Harris on corners, relative to the level's max |Harris|: direct 7-tap
#: sums in the kernel against cumsum differences in the plain version
HARRIS_RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _levels(dev, h=288, w=384):
    ts = np.zeros((1, 3))
    img = torch.from_numpy(render_planes_sequence(ts, h=h, w=w,
                                                  focal=300.0)[0]).to(dev)
    shapes = features._level_shapes(h, w, P)
    levels = [img]
    for shape in shapes[1:]:
        levels.append(features.resize_level(levels[-1], shape).contiguous())
    return levels


@pytest.mark.parametrize("size", [(288, 384), (480, 640), (100, 70)])
def test_kernel_matches_plain_on_every_level(dev, size):
    for lv in _levels(dev, *size):
        k = features_cuda.fast_nms_harris_rank(lv, P.fast_threshold,
                                               P.harris_k, P.border)
        r = features_cuda.fast_nms_harris_rank_ref(lv, P.fast_threshold,
                                                   P.harris_k, P.border)
        torch.cuda.synchronize()
        fin = torch.isfinite(r)
        assert torch.equal(torch.isfinite(k), fin), tuple(lv.shape)
        if fin.any():
            scale = float(r[fin].abs().max())
            assert float((k[fin] - r[fin]).abs().max()) <= HARRIS_RTOL * scale


def test_kernel_counts_launches(dev):
    lv = _levels(dev)[0]
    before = features_cuda.fast_nms_harris_rank.launches
    features_cuda.fast_nms_harris_rank(lv, P.fast_threshold, P.harris_k,
                                       P.border)
    assert features_cuda.fast_nms_harris_rank.launches == before + 1


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "3d"])
def test_wrapper_rejects_what_the_kernel_does_not_take(dev, bad):
    lv = _levels(dev)[0]
    x = {"float64": lv.double(), "non_contiguous": lv.t(),
         "3d": lv[None]}[bad]
    with pytest.raises(ValueError):
        features_cuda.fast_nms_harris_rank(x, P.fast_threshold, P.harris_k,
                                           P.border)


def test_tracker_steps_on_the_card(dev):
    params = VoJitParams()
    ts = np.stack([np.arange(3) * 0.12, np.zeros(3), np.zeros(3)], 1)
    frames = torch.from_numpy(render_planes_sequence(ts, h=288, w=384,
                                                     focal=300.0)).to(dev)
    K_inv = torch.tensor(np.linalg.inv(np.asarray(
        [[300.0, 0, 191.5], [0, 300.0, 143.5], [0, 0, 1]])),
        dtype=torch.float32, device=dev)
    step = make_vo_step(params)
    state = vo_init_state(params, device=dev)
    before = features_cuda.fast_nms_harris_rank.launches
    modes = []
    for t in range(3):
        state, out = step(state, frames[t], K_inv, 300.0)
        modes.append(int(out.mode))
    assert features_cuda.fast_nms_harris_rank.launches == before + 3 * 8
    assert modes == [1, 2, 2]
    assert bool(torch.isfinite(state.pose_t).all())
