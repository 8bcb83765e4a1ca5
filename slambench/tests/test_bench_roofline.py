"""K1's least time against PERF.md's figures for the 8-level 288x384
pyramid of the bench frame: 2,740,224 bytes at 3.35 TB/s (0.00082 ms)
and 38.7 MFLOP at 67 TFLOP/s (0.00058 ms): bound by bytes."""

import numpy as np
import pytest
import torch

from mvslam_tpu_torch.utils.scene import render_planes_sequence
from slambench import reference, roofline


def bench_frame():
    ts = np.zeros((1, 3))
    return torch.from_numpy(render_planes_sequence(ts, h=288, w=384,
                                                   focal=300.0)[0])


def test_bytes_of_the_288x384_pyramid():
    shapes = reference.level_shapes(288, 384, reference.Orb())
    b = roofline.k1_bound(shapes, 0, 0)
    assert b["bytes"] == 2_740_224
    assert b["seconds"] * 1e3 == pytest.approx(0.00082, abs=5e-6)
    assert b["bound_by"] == "bytes"


def test_operations_of_the_bench_frame():
    orb = reference.Orb()
    levels = reference.pyramid(bench_frame(), orb)
    cand = sum(roofline.compass_candidates(lv, orb.fast_threshold)
               for lv in levels)
    corners = sum(int(torch.isfinite(reference.rank_map(lv, orb)).sum())
                  for lv in levels)
    b = roofline.k1_bound([tuple(lv.shape) for lv in levels], cand, corners)
    assert b["flops"] / 1e6 == pytest.approx(38.7, abs=0.05)
    assert b["flops"] / roofline.H100_F32_FLOPS * 1e3 == pytest.approx(
        0.00058, abs=5e-6)
    assert b["bound_by"] == "bytes"
