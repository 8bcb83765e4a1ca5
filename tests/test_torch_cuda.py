"""The PyTorch port's CUDA kernel on the card: both wrappers against the
plain version at the tracker's pyramid shapes, the pyramid call's views
against per-level calls, the wrappers' checks and launch count, and the
tracker's steps on the device. Every test needs a CUDA card
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
    return features.pyramid(img, P)


ARGS = (P.fast_threshold, P.harris_k, P.border)
SIZES = [(288, 384), (480, 640), (100, 70)]


def _assert_matches_plain(k, lv):
    r = features_cuda.fast_nms_harris_rank_ref(lv, *ARGS)
    fin = torch.isfinite(r)
    assert torch.equal(torch.isfinite(k), fin), tuple(lv.shape)
    if fin.any():
        scale = float(r[fin].abs().max())
        assert float((k[fin] - r[fin]).abs().max()) <= HARRIS_RTOL * scale


@pytest.mark.parametrize("size", SIZES)
def test_kernel_matches_plain_on_every_level(dev, size):
    for lv in _levels(dev, *size):
        k = features_cuda.fast_nms_harris_rank(lv, *ARGS)
        torch.cuda.synchronize()
        _assert_matches_plain(k, lv)


@pytest.mark.parametrize("size", SIZES)
def test_pyramid_call_matches_plain_on_every_level(dev, size):
    levels = _levels(dev, *size)
    ranks = features_cuda.fast_nms_harris_rank_pyramid(levels, *ARGS)
    torch.cuda.synchronize()
    assert len(ranks) == len(levels)
    for lv, k in zip(levels, ranks):
        assert k.shape == lv.shape and k.is_contiguous()
        _assert_matches_plain(k, lv)


@pytest.mark.parametrize("size", SIZES)
def test_pyramid_views_equal_per_level_calls_bitwise(dev, size):
    levels = _levels(dev, *size)
    ranks = features_cuda.fast_nms_harris_rank_pyramid(levels, *ARGS)
    for lv, k in zip(levels, ranks):
        assert torch.equal(k, features_cuda.fast_nms_harris_rank(lv, *ARGS))


def test_unaligned_level_pointer_takes_the_scalar_load(dev):
    """A level whose first pixel is not 16-byte aligned (a view one float
    into a buffer) gives the same map as its aligned copy."""
    lv = _levels(dev)[0]
    buf = torch.empty(lv.numel() + 1, device=dev)
    shifted = buf[1:].view_as(lv).copy_(lv)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    assert torch.equal(features_cuda.fast_nms_harris_rank(shifted, *ARGS),
                       features_cuda.fast_nms_harris_rank(lv, *ARGS))


def test_kernel_counts_launches(dev):
    """One launch per call of either wrapper, however many levels."""
    levels = _levels(dev)
    before = features_cuda.fast_nms_harris_rank_pyramid.launches
    features_cuda.fast_nms_harris_rank_pyramid(levels, *ARGS)
    assert features_cuda.fast_nms_harris_rank_pyramid.launches == before + 1
    features_cuda.fast_nms_harris_rank(levels[0], *ARGS)
    assert features_cuda.fast_nms_harris_rank_pyramid.launches == before + 2


def test_pyramid_launch_is_captured_in_a_cuda_graph(dev):
    """The launch is on the current stream and synchronises nothing, so a
    CUDA graph takes it; a replay on new pixels gives the eager maps."""
    levels = _levels(dev)
    static = [lv.clone() for lv in levels]
    features_cuda.fast_nms_harris_rank_pyramid(static, *ARGS)   # build, load
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ranks = features_cuda.fast_nms_harris_rank_pyramid(static, *ARGS)
    for s in static:
        s.copy_(s.flip(1))
    graph.replay()
    torch.cuda.synchronize()
    for s, k in zip(static, ranks):
        assert torch.equal(k, features_cuda.fast_nms_harris_rank(s, *ARGS))


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "3d"])
def test_wrapper_rejects_what_the_kernel_does_not_take(dev, bad):
    lv = _levels(dev)[0]
    x = {"float64": lv.double(), "non_contiguous": lv.t(),
         "3d": lv[None]}[bad]
    with pytest.raises(ValueError):
        features_cuda.fast_nms_harris_rank(x, *ARGS)
    with pytest.raises(ValueError):
        features_cuda.fast_nms_harris_rank_pyramid([lv, x], *ARGS)


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
    before = features_cuda.fast_nms_harris_rank_pyramid.launches
    modes = []
    for t in range(3):
        state, out = step(state, frames[t], K_inv, 300.0)
        modes.append(int(out.mode))
    assert features_cuda.fast_nms_harris_rank_pyramid.launches == before + 3
    assert modes == [1, 2, 2]
    assert bool(torch.isfinite(state.pose_t).all())
