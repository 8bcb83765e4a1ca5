"""What the tracker's CUDA graphs are keyed by (``vo_jit._graph_key``, the
key of each ``vo_jit._StageRunner``'s ``captures``), on the CPU: the
devices, dtypes and shapes of the inputs' tensors, one per tensor of a
list or tuple (the pyramid's levels, the corner kernel's rank maps), and
any other input's value (a focal given as a number). Another
image size keys another capture; the next frame's tensors, or another
focal given as a tensor, key the same one. The captures themselves need a
card (``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from mvslam_tpu_torch.frontend import vo_jit
from mvslam_tpu_torch.ops.features import OrbParams, pyramid

PARAMS = OrbParams(max_features=64)


def _inputs(h, w, focal, seed=0):
    g = torch.Generator().manual_seed(seed)
    levels = pyramid(torch.rand((h, w), generator=g), PARAMS)
    ranks = [torch.rand(lv.shape, generator=g) for lv in levels]
    return dict(levels=levels, ranks=ranks, K_inv=torch.eye(3),
                focal=focal)


def test_next_frame_keys_the_same_capture():
    a = _inputs(96, 128, torch.tensor(280.0))
    b = _inputs(96, 128, torch.tensor(300.0), seed=1)
    assert vo_jit._graph_key(a) == vo_jit._graph_key(b)


@pytest.mark.parametrize("size", [(97, 128), (128, 96), (240, 320)])
def test_another_image_size_keys_another_capture(size):
    a = _inputs(96, 128, 280.0)
    b = _inputs(*size, 280.0)
    assert vo_jit._graph_key(a) != vo_jit._graph_key(b)


def test_a_focal_given_as_a_number_is_part_of_the_key():
    a = vo_jit._graph_key(_inputs(96, 128, 280.0))
    assert a != vo_jit._graph_key(_inputs(96, 128, 300.0))
    assert a != vo_jit._graph_key(_inputs(96, 128, torch.tensor(280.0)))
    assert dict(a)["focal"] == 280.0


def test_lists_and_tuples_of_tensors_are_buffers_of_one_key():
    inputs = _inputs(96, 128, 280.0)
    as_tuples = dict(inputs, levels=tuple(inputs["levels"]),
                     ranks=tuple(inputs["ranks"]))
    assert vo_jit._graph_key(inputs) == vo_jit._graph_key(as_tuples)
    levels = inputs["levels"]
    assert vo_jit._tensors(levels) == tuple(levels)
    assert vo_jit._tensors(levels[0]) == (levels[0],)
    assert vo_jit._tensors(280.0) is None
    assert vo_jit._tensors([levels[0], 1.0]) is None
    dtype_key = dict(vo_jit._graph_key(dict(
        inputs, K_inv=torch.eye(3, dtype=torch.float64))))["K_inv"]
    assert dtype_key == ((torch.device("cpu"), torch.float64, (3, 3)),)
