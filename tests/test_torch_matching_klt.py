"""Descriptor matching and KLT refinement: the PyTorch port against JAX.

Descriptors cross as the same bits: JAX's uint32 words viewed as int32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.ops import klt as jk
from mvslam_tpu.ops import matching as jm
from mvslam_tpu_torch.ops import klt as tk
from mvslam_tpu_torch.ops import matching as tm
from mvslam_tpu_torch.utils.scene import render_planes_sequence

#: KLT positions: 10 Gauss-Newton iterations on bilinear samples whose
#: template sums run in another float32 order; well inside the 0.25 px
#: measurement sigma the tracker assigns
KLT_ATOL_PX = 1e-4


def _descriptor_sets(seed=0, n1=300, n2=400, flips=20):
    """Train set of random words; queries are noisy copies of a subset (so
    ratio-test passes and failures both occur) plus unrelated words."""
    rng = np.random.default_rng(seed)
    d2 = rng.integers(0, 2 ** 32, size=(n2, 8), dtype=np.uint64).astype(
        np.uint32)
    src = rng.permutation(n2)[:n1]
    d1 = d2[src].copy()
    for i in range(n1):
        for _ in range(rng.integers(0, flips)):
            w, b = rng.integers(0, 8), rng.integers(0, 32)
            d1[i, w] ^= np.uint32(1 << int(b))
    d1[n1 // 2:] = rng.integers(0, 2 ** 32, size=(n1 - n1 // 2, 8),
                                dtype=np.uint64).astype(np.uint32)
    d2[5] = d2[7]                  # an exact tie in the train set
    m1 = rng.uniform(size=n1) > 0.1
    m2 = rng.uniform(size=n2) > 0.1
    return d1, m1, d2, m2


def test_hamming_matrix_exact():
    d1, _, d2, _ = _descriptor_sets()
    want = np.asarray(jm.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    got = tm.hamming_matrix(torch.from_numpy(d1.view(np.int32)),
                            torch.from_numpy(d2.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_distance,cross_check", [
    (None, False), (64, False), (64, True)])
def test_match_features_exact(max_distance, cross_check):
    d1, m1, d2, m2 = _descriptor_sets(seed=1)
    want = jm.match_features(jnp.asarray(d1), jnp.asarray(m1),
                             jnp.asarray(d2), jnp.asarray(m2),
                             max_distance=max_distance,
                             cross_check=cross_check)
    got = tm.match_features(torch.from_numpy(d1.view(np.int32)),
                            torch.from_numpy(m1), torch.from_numpy(
                                d2.view(np.int32)), torch.from_numpy(m2),
                            max_distance, cross_check=cross_check)
    mask = np.asarray(want.mask)
    assert 50 < mask.sum() < len(mask)
    np.testing.assert_array_equal(got.mask.numpy(), mask)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    np.testing.assert_array_equal(got.second_dist.numpy(),
                                  np.asarray(want.second_dist))


@pytest.fixture(scope="module")
def klt_scene():
    ts = np.array([[0.0, 0.0, 0.0], [0.05, 0.01, 0.0]])
    f0, f1 = render_planes_sequence(ts, h=240, w=320, focal=280.0,
                                    bg_slope=0.18)
    rng = np.random.default_rng(2)
    xy = np.stack([rng.uniform(30, 290, 200), rng.uniform(30, 210, 200)],
                  1).astype(np.float32)
    # the scene shifts by ~1-3.5 px; start from a rounded guess, as the
    # tracker does from integer corner positions
    xy_init = np.round(xy - np.array([2.0, 0.5], np.float32)).astype(
        np.float32)
    mask = rng.uniform(size=200) > 0.1
    return f0, f1, xy, xy_init, mask


def test_smooth_image_exact(klt_scene):
    f0 = klt_scene[0]
    np.testing.assert_array_equal(
        tk.smooth_image(torch.from_numpy(f0)).numpy(),
        np.asarray(jk.smooth_image(jnp.asarray(f0))))


def test_extract_templates_close(klt_scene):
    f0, _, xy, _, _ = klt_scene
    s0 = np.asarray(jk.smooth_image(jnp.asarray(f0)))
    want = np.asarray(jk.extract_templates(jnp.asarray(s0), jnp.asarray(xy)))
    got = tk.extract_templates(torch.from_numpy(s0),
                               torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_klt_track_matches(klt_scene):
    f0, f1, xy, xy_init, mask = klt_scene
    s0 = np.asarray(jk.smooth_image(jnp.asarray(f0)))
    s1 = np.asarray(jk.smooth_image(jnp.asarray(f1)))
    tmpl = np.asarray(jk.extract_templates(jnp.asarray(s0), jnp.asarray(xy)))
    want = jk.klt_track(jnp.asarray(tmpl), jnp.asarray(s1),
                        jnp.asarray(xy_init), jnp.asarray(mask))
    got = tk.klt_track(torch.from_numpy(tmpl), torch.from_numpy(s1),
                       torch.from_numpy(xy_init), torch.from_numpy(mask))
    valid = np.asarray(want.valid)
    assert valid.sum() > 100
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(want.xy), rtol=0,
                               atol=KLT_ATOL_PX)
    np.testing.assert_allclose(got.residual.numpy(),
                               np.asarray(want.residual), rtol=0, atol=1e-5)
