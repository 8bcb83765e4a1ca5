"""ORB features and the dense corner front: the PyTorch port against JAX.

Inputs are float32 on both sides (the session runs JAX with x64 on). The
corner front's plain torch composition (what the CUDA kernel is checked
against on the card) is held to the JAX package's unfused composition and
to the Pallas kernel itself, run by the Pallas interpreter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.ops import features as jf
from mvslam_tpu.ops.features_pallas import fast_nms_harris_rank as pallas_rank
from mvslam_tpu_torch.ops import features as tf
from mvslam_tpu_torch.ops import features_cuda as tfc
from mvslam_tpu_torch.utils.scene import render_planes_sequence

P = jf.OrbParams()
#: Harris rank maps, relative to the level's max |Harris|: the JAX box sum
#: is a blocked float32 cumsum (XLA's reduce_window), the port's CPU cumsum
#: accumulates in float64, so the 7x7 sums differ by float32 rounding of
#: running sums; measured 2.5e-6 at 240x320
HARRIS_RTOL = 1e-5


def _frame(h=240, w=320, k=0):
    ts = np.stack([np.arange(k + 1) * 0.12, np.zeros(k + 1),
                   np.zeros(k + 1)], 1)
    return render_planes_sequence(ts, h=h, w=w, focal=280.0 * w / 320,
                                  bg_slope=0.18)[k]


def _jax_rank(img):
    ji = jnp.asarray(img, jnp.float32)
    score = jf._suppress_border(jf.nms3x3(jf.fast_score(ji, P.fast_threshold)),
                                P.border)
    harris = jf.harris_response(ji, P.harris_k)
    return np.asarray(jnp.where(score > 0, harris, -jnp.inf))


def _assert_rank_close(got, want):
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    assert fin.sum() > 50
    scale = np.abs(want[fin]).max()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=HARRIS_RTOL * scale)


def test_rank_ref_matches_jax_composition():
    img = _frame()
    got = tfc.fast_nms_harris_rank_ref(torch.from_numpy(img), P.fast_threshold,
                                       P.harris_k, P.border).numpy()
    _assert_rank_close(got, _jax_rank(img))


def test_rank_ref_matches_pallas_kernel_interpreted():
    img = _frame(120, 160)
    want = np.asarray(pallas_rank(jnp.asarray(img, jnp.float32),
                                  P.fast_threshold, P.harris_k, P.border,
                                  interpret=True))
    got = tfc.fast_nms_harris_rank_ref(torch.from_numpy(img), P.fast_threshold,
                                       P.harris_k, P.border).numpy()
    _assert_rank_close(got, want)


def test_dispatcher_runs_plain_version_on_cpu():
    img = torch.from_numpy(_frame(96, 128))
    before = tfc.fast_nms_harris_rank.launches
    got = tfc.fast_nms_harris_rank(img, P.fast_threshold, P.harris_k, P.border)
    want = tfc.fast_nms_harris_rank_ref(img, P.fast_threshold, P.harris_k,
                                        P.border)
    assert torch.equal(got, want)
    assert tfc.fast_nms_harris_rank.launches == before


def test_dispatcher_rejects_border_below_halo():
    img = torch.zeros(64, 64)
    with pytest.raises(ValueError):
        tfc.fast_nms_harris_rank(img, P.fast_threshold, P.harris_k,
                                 tfc.MIN_BORDER - 1)


@pytest.mark.parametrize("name", ["fast_score", "nms3x3", "sep_filter3",
                                  "box_sum_shifts", "suppress_border"])
def test_dense_stages_bit_exact(name):
    """Elementwise stages in the same operation order: bit-exact."""
    img = _frame(96, 128)
    ji, ti = jnp.asarray(img, jnp.float32), torch.from_numpy(img)
    if name == "fast_score":
        want = jf.fast_score(ji, P.fast_threshold)
        got = tf.fast_score(ti, P.fast_threshold)
    elif name == "nms3x3":
        s = jf.fast_score(ji, P.fast_threshold)
        want = jf.nms3x3(s)
        got = tf.nms3x3(torch.tensor(np.asarray(s)))
    elif name == "sep_filter3":
        want = jf.sep_filter3(ji, (0.125, 0.25, 0.125), (-1.0, 0.0, 1.0))
        got = tf.sep_filter3(ti, (0.125, 0.25, 0.125), (-1.0, 0.0, 1.0))
    elif name == "box_sum_shifts":
        stack = np.stack([img[:35, :35], img[10:45, 20:55]])
        want = jf._box_sum_shifts(jnp.asarray(stack), 2)
        got = tf._box_sum_shifts(torch.from_numpy(stack), 2)
    else:
        want = jf._suppress_border(ji, P.border)
        got = tf._suppress_border(ti, P.border)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_harris_response_close():
    img = _frame(96, 128)
    want = np.asarray(jf.harris_response(jnp.asarray(img), P.harris_k))
    got = tf.harris_response(torch.from_numpy(img), P.harris_k).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=HARRIS_RTOL * np.abs(want).max())


def test_pyramid_resize_matches_jax_image_resize():
    """Antialiased bilinear downscale: the two libraries compute the
    separable filter weights with different float32 rounding (measured
    1e-5 on one pixel of 53400, 2.4e-6 typical)."""
    img = _frame()
    want = np.asarray(jax.image.resize(jnp.asarray(img), (200, 267), "linear"))
    got = tf.resize_level(torch.from_numpy(img), (200, 267)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_orientation_and_descriptors_match():
    """Same patches: angles agree to float32 summation order (moments of
    ~700 terms with cancellation: measured 1.2e-5 rad on uniform noise);
    given the same smoothed patches and angles, descriptor words are
    identical."""
    rng = np.random.default_rng(3)
    patches = rng.uniform(size=(64, 35, 35)).astype(np.float32)
    want_a = np.asarray(jf._orientation(jnp.asarray(patches)))
    got_a = tf._orientation(torch.from_numpy(patches)).numpy()
    np.testing.assert_allclose(got_a, want_a, rtol=0, atol=5e-5)
    smooth = np.asarray(jf._box_sum_shifts(jnp.asarray(patches), 2)) / 25.0
    want_d = np.asarray(jf._descriptors(jnp.asarray(smooth),
                                        jnp.asarray(want_a))).view(np.int32)
    got_d = tf._descriptors(torch.from_numpy(smooth),
                            torch.from_numpy(want_a)).numpy()
    np.testing.assert_array_equal(got_d, want_d)


def test_top_k_keeps_lower_index_first_on_ties():
    x = np.array([1.0, 3.0, 3.0, -np.inf, 2.0, 3.0, -np.inf], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 6)
    tv, ti = tf.top_k(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.fixture(scope="module")
def orb_pair():
    img = _frame()
    fj = jf.orb_detect(jnp.asarray(img, jnp.float32), jf.OrbParams())
    ft = tf.orb_detect(torch.from_numpy(img), tf.OrbParams())
    return jax.tree_util.tree_map(np.asarray, fj), ft


def test_orb_detect_masks_match(orb_pair):
    fj, ft = orb_pair
    np.testing.assert_array_equal(ft.mask.numpy(), fj.mask)
    np.testing.assert_array_equal(ft.octave.numpy(), fj.octave)
    assert fj.mask.sum() > 300


def test_orb_detect_keypoints_and_descriptors_match(orb_pair):
    """Kept keypoints are the same set (Harris drift may swap the rank
    order of near-ties inside a level); each carries the same descriptor
    bits and, to float32 summation order, the same angle."""
    fj, ft = orb_pair

    def keyed(xy, octave, mask):
        return {(int(o), float(x), float(y)): i for i, (o, (x, y), m)
                in enumerate(zip(octave, xy, mask)) if m}

    kj = keyed(fj.xy, fj.octave, fj.mask)
    kt = keyed(ft.xy.numpy(), ft.octave.numpy(), ft.mask.numpy())
    assert kj.keys() == kt.keys()
    ij = np.array([kj[k] for k in kj])
    it = np.array([kt[k] for k in kj])
    np.testing.assert_array_equal(ft.desc.numpy()[it],
                                  fj.desc[ij].view(np.int32))
    np.testing.assert_allclose(ft.angle.numpy()[it], fj.angle[ij], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(ft.sigma.numpy()[it], fj.sigma[ij])
