"""The two ORB options, ``OrbParams.batched`` (the canvas layout of the
per-keypoint half) and ``OrbParams.subpixel`` (a parabola fitted on each
kept corner's Harris neighbourhood): the port against itself and against
the JAX package, float32 on both sides (the test suite runs JAX with x64
on).

The batched layout is a layout switch, not a semantics switch: on the
bench's synthetic 288x384 frame it gives exactly the unrolled layout's
features (the case of ``tests/test_features.py::
test_orb_batched_layout_parity``, which reads tsukuba frames). Against JAX
the kept keypoints are the same set, keyed by octave and integer anchor
(Harris drift may swap the rank order of near-ties inside a level), each
with the same descriptor bits, on the 240x320 loop frame: on the 288x384
frame two descriptors of octaves 1-2 differ from JAX's in either layout,
as on the default path, because the two libraries' antialiased resizes
round differently (``test_torch_features.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.ops import features as jf
from mvslam_tpu_torch.ops import features as tf
from mvslam_tpu_torch.ops import features_cuda as tfc
from mvslam_tpu_torch.utils.scene import render_planes_sequence

#: angles, unrolled vs batched in the port: the moment sums of one level's
#: keypoints and of all K keypoints reduce in another order (measured
#: 2.4e-7 rad on the CPU)
LAYOUT_ANGLE_ATOL = 1e-6
#: angles, port vs JAX: float32 moment sums in another order
#: (``test_torch_features.py``)
JAX_ANGLE_ATOL = 1e-4
#: subpixel positions, port vs JAX, in pixels of the keypoint's level: the
#: parabola reads Harris values whose 7x7 box sums are cumsum differences,
#: which XLA accumulates in float32 and the port in float64 (measured
#: 8.1e-5 on the 240x320 frame, 9.5e-5 on the 288x384 one)
SUBPIXEL_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of small ops per call: with the suite's workers side by
    side, torch's intra-op pool only makes them fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bench_frame():
    """The bench's synthetic scene (``bench.py:304-335``), frame 0."""
    return render_planes_sequence(np.zeros((1, 3)), h=288, w=384,
                                  focal=300.0)[0]


def loop_frame():
    """The first frame of the 240x320 scene of ``test_torch_features.py``."""
    return render_planes_sequence(np.zeros((1, 3)), h=240, w=320,
                                  focal=280.0, bg_slope=0.18)[0]


OPTIONS = [dict(), dict(subpixel=True)]
IDS = ["integer", "subpixel"]


@pytest.fixture(scope="module")
def bench_port():
    img = torch.from_numpy(bench_frame())
    return {(bat, sub): tf.orb_detect(img, tf.OrbParams(batched=bat,
                                                        subpixel=sub))
            for bat in (False, True) for sub in (False, True)}


@pytest.mark.parametrize("opts", OPTIONS, ids=IDS)
def test_batched_layout_equals_unrolled(bench_port, opts):
    """Mask, valid ``xy``, octave, descriptors exactly; angles within
    LAYOUT_ANGLE_ATOL; response and sigma equal."""
    sub = bool(opts)
    f_u, f_b = bench_port[(False, sub)], bench_port[(True, sub)]
    m = f_u.mask.numpy()
    assert m.sum() == 512
    np.testing.assert_array_equal(f_b.mask.numpy(), m)
    np.testing.assert_array_equal(f_b.xy.numpy()[m], f_u.xy.numpy()[m])
    np.testing.assert_array_equal(f_b.octave.numpy(), f_u.octave.numpy())
    np.testing.assert_array_equal(f_b.desc.numpy()[m], f_u.desc.numpy()[m])
    np.testing.assert_allclose(f_b.angle.numpy()[m], f_u.angle.numpy()[m],
                               rtol=0, atol=LAYOUT_ANGLE_ATOL)
    np.testing.assert_array_equal(f_b.response.numpy(),
                                  f_u.response.numpy())
    np.testing.assert_array_equal(f_b.sigma.numpy(), f_u.sigma.numpy())
    for f in (f_u, f_b):
        assert f.desc.dtype == torch.int32 and f.octave.dtype == torch.int32
        assert f.xy.dtype == f.sigma.dtype == torch.float32


def test_jax_batched_layout_equals_unrolled_on_the_bench_frame():
    """The JAX package's own claim, on the frame the port is held to."""
    img = jnp.asarray(bench_frame(), jnp.float32)
    f_u = jf.orb_detect(img, jf.OrbParams(batched=False))
    f_b = jf.orb_detect(img, jf.OrbParams(batched=True))
    m = np.asarray(f_u.mask)
    np.testing.assert_array_equal(np.asarray(f_b.mask), m)
    np.testing.assert_array_equal(np.asarray(f_b.xy)[m], np.asarray(f_u.xy)[m])
    np.testing.assert_array_equal(np.asarray(f_b.desc)[m],
                                  np.asarray(f_u.desc)[m])


def test_subpixel_moves_keypoints_within_half_a_pixel(bench_port):
    """The subpixel run keeps the integer run's keypoints in the same slots
    and moves each by at most half a pixel of its level; a corner that is
    no 1-D maximum of Harris along an axis stays put on it (measured: 42 %
    of the 512 move)."""
    f0, f1 = bench_port[(False, False)], bench_port[(False, True)]
    m = f0.mask.numpy()
    np.testing.assert_array_equal(f1.mask.numpy(), m)
    np.testing.assert_array_equal(f1.desc.numpy(), f0.desc.numpy())
    np.testing.assert_array_equal(f1.angle.numpy(), f0.angle.numpy())
    scale = 1.2 ** f0.octave.numpy()[m]
    off = (f1.xy.numpy()[m] - f0.xy.numpy()[m]) / scale[:, None]
    assert np.abs(off).max() <= 0.5 + 1e-5
    assert 0.25 < (np.abs(off) > 1e-3).any(axis=1).mean() < 0.75


def _keyed(xy, octave, mask):
    """Slot of each valid keypoint by (octave, level-0 integer position)."""
    return {(int(o), float(x), float(y)): i
            for i, (o, (x, y), m) in enumerate(zip(octave, xy, mask)) if m}


@pytest.mark.parametrize("batched", [False, True], ids=["unrolled", "batched"])
@pytest.mark.parametrize("opts", OPTIONS, ids=IDS)
def test_port_matches_jax(opts, batched):
    """Same masks and octaves, the same keypoint set keyed by integer
    anchor, equal descriptors, angles within JAX_ANGLE_ATOL; under
    subpixel, positions within SUBPIXEL_ATOL px of the level."""
    img = loop_frame()
    ti, ji = torch.from_numpy(img), jnp.asarray(img, jnp.float32)
    p = dict(batched=batched, **opts)
    ft = tf.orb_detect(ti, tf.OrbParams(**p))
    fj = jax.tree_util.tree_map(np.asarray,
                                jf.orb_detect(ji, jf.OrbParams(**p)))
    # integer anchors: the same option without subpixel keeps the same slots
    at = tf.orb_detect(ti, tf.OrbParams(batched=batched)).xy.numpy()
    aj = np.asarray(jf.orb_detect(ji, jf.OrbParams(batched=batched)).xy)
    np.testing.assert_array_equal(ft.mask.numpy(), fj.mask)
    np.testing.assert_array_equal(ft.octave.numpy(), fj.octave)
    kt = _keyed(at, ft.octave.numpy(), ft.mask.numpy())
    kj = _keyed(aj, fj.octave, fj.mask)
    assert kt.keys() == kj.keys() and len(kj) == 512
    it = np.array([kt[k] for k in kj])
    ij = np.array([kj[k] for k in kj])
    np.testing.assert_array_equal(ft.desc.numpy()[it],
                                  fj.desc[ij].view(np.int32))
    np.testing.assert_allclose(ft.angle.numpy()[it], fj.angle[ij], rtol=0,
                               atol=JAX_ANGLE_ATOL)
    scale = (1.2 ** fj.octave[ij])[:, None]
    np.testing.assert_allclose(ft.xy.numpy()[it] / scale, fj.xy[ij] / scale,
                               rtol=0, atol=SUBPIXEL_ATOL)


def test_subpixel_offset_matches_jax():
    """The parabola alone on the same neighbourhoods: exact in float32,
    clamped at half a pixel, zero off a 1-D maximum and on a flat row."""
    rng = np.random.default_rng(0)
    nb = rng.normal(size=(200, 3)).astype(np.float32)
    nb[:50, 1] = np.abs(nb[:50]).max(1) + 0.1          # true maxima
    nb[50:60] = 1.0                                      # flat
    nb[60:70, 0] = nb[60:70, 1]                          # half-pixel fits
    nb[60:70, 2] = nb[60:70, 1] - 1.0
    got = tf._parabolic_offset(*torch.from_numpy(nb).unbind(1)).numpy()
    want = np.asarray(jf._parabolic_offset(*jnp.asarray(nb).T))
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() == 0.5 and (got[50:60] == 0).all()


def test_canvas_patches_match_jax():
    """The one patch gather over an (L, H, W) canvas: the JAX function's
    patches, zero outside the canvas."""
    rng = np.random.default_rng(1)
    canvas = rng.uniform(size=(3, 40, 50)).astype(np.float32)
    lev = np.array([0, 2, 1, 2, 0], np.int64)
    xy = np.array([[0, 0], [49, 39], [20.4, 13.6], [3, 30], [25, 2]],
                  np.float32)
    want = np.asarray(jf._extract_patches_lhw(
        jnp.asarray(canvas), jnp.asarray(lev, jnp.int32), jnp.asarray(xy), 4))
    got = tf._extract_patches_lhw(torch.from_numpy(canvas),
                                  torch.from_numpy(lev),
                                  torch.from_numpy(xy), 4).numpy()
    np.testing.assert_array_equal(got, want)


def test_one_corner_kernel_call_per_image_in_both_layouts(monkeypatch):
    """Each option calls the corner kernel's wrapper once per image with
    the whole pyramid (the card's one launch)."""
    calls = []
    real = tfc.fast_nms_harris_rank_flat

    def spy(levels, *args):
        calls.append(len(levels))
        return real(levels, *args)

    monkeypatch.setattr(tfc, "fast_nms_harris_rank_flat", spy)
    img = torch.from_numpy(loop_frame())
    for bat in (False, True):
        for sub in (False, True):
            tf.orb_detect(img, tf.OrbParams(batched=bat, subpixel=sub,
                                            max_features=64))
    assert calls == [8, 8, 8, 8]


@pytest.mark.parametrize("opts", OPTIONS, ids=IDS)
@pytest.mark.parametrize("batched", [False, True], ids=["unrolled", "batched"])
def test_keypoints_from_copied_ranks_equal_orb_detect(opts, batched):
    """The per-keypoint half (``orb_keypoints``) read from copies of the
    pyramid and of the corner kernel's output, as a CUDA graph's input
    buffers hold them, gives ``orb_detect``'s features bit for bit; the
    unrolled layout's rank maps are views of one buffer, the copies are
    not."""
    p = tf.OrbParams(batched=batched, max_features=64, **opts)
    img = torch.from_numpy(loop_frame())
    want = tf.orb_detect(img, p)
    levels = tf.pyramid(img, p)
    ranks = tf.corner_ranks(levels, p)
    assert isinstance(ranks, torch.Tensor) == batched
    copies = (ranks.clone() if batched else tuple(r.clone() for r in ranks))
    got = tf.orb_keypoints(tuple(lv.clone() for lv in levels), copies, p)
    for name, a, b in zip(tf.FeatureSet._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_brief_pattern_is_built_once_per_device_and_dtype(dtype):
    """``_descriptors`` takes the rBRIEF pattern from a tensor built once
    per device and dtype, holding ``_PATTERN``'s values, and describes as
    with the pattern converted on each call."""
    cpu = torch.device("cpu")
    pat = tf._device_pattern(cpu, dtype)
    assert pat.dtype == dtype and pat.device == cpu
    assert torch.equal(pat, torch.as_tensor(tf._PATTERN, dtype=dtype))
    rng = np.random.default_rng(5)
    smooth = torch.from_numpy(rng.uniform(size=(32, 35, 35))).to(dtype)
    angles = torch.from_numpy(rng.uniform(-np.pi, np.pi, 32)).to(dtype)
    before = tf._device_pattern.cache_info()
    got = tf._descriptors(smooth, angles)
    after = tf._device_pattern.cache_info()
    assert after.misses == before.misses and after.hits == before.hits + 1
    assert tf._device_pattern(cpu, dtype) is pat
    # the descriptor as written before the cache: the pattern converted here
    c = (smooth.shape[-1] - 1) / 2.0
    x = torch.as_tensor(tf._PATTERN, dtype=dtype)[None, ..., 0]
    y = torch.as_tensor(tf._PATTERN, dtype=dtype)[None, ..., 1]
    cos, sin = torch.cos(angles)[:, None, None], torch.sin(angles)[:, None,
                                                                  None]
    xi = torch.clamp(torch.round(cos * x - sin * y + c), 0, 34).long()
    yi = torch.clamp(torch.round(sin * x + cos * y + c), 0, 34).long()
    s = smooth[torch.arange(32)[:, None, None], yi, xi]
    assert torch.equal(got, tf._pack_words(s[..., 0] < s[..., 1]))


@pytest.mark.parametrize("size", [(100, 70), (96, 128)])
def test_batched_on_clamped_pyramids(size):
    """Upper levels clamp to 2 * border + 1 (no longer a scaled copy of the
    level below): both layouts still agree."""
    img = torch.from_numpy(render_planes_sequence(
        np.zeros((1, 3)), h=size[0], w=size[1], focal=90.0)[0])
    shapes = [tuple(lv.shape) for lv in tf.pyramid(img)]
    f_u = tf.orb_detect(img, tf.OrbParams(max_features=64))
    f_b = tf.orb_detect(img, tf.OrbParams(max_features=64, batched=True))
    m = f_u.mask.numpy()
    np.testing.assert_array_equal(f_b.mask.numpy(), m)
    np.testing.assert_array_equal(f_b.xy.numpy()[m], f_u.xy.numpy()[m])
    np.testing.assert_array_equal(f_b.desc.numpy()[m], f_u.desc.numpy()[m])
    assert shapes[-1] == (39, 39)


def test_orb_params_carry_over_from_jax_field_for_field():
    """A JAX ``OrbParams`` with every field set away from its default
    constructs the port's ``OrbParams`` with the same values."""
    assert tf.OrbParams._fields == jf.OrbParams._fields
    jp = jf.OrbParams(max_features=300, fast_threshold=0.1, harris_k=0.05,
                      num_levels=5, scale_factor=1.3, border=21,
                      subpixel=True, batched=True, pallas_dense=True,
                      pallas_interpret=True)
    assert all(getattr(jp, f) != getattr(jf.OrbParams(), f)
               for f in jf.OrbParams._fields)
    tp = tf.OrbParams(**jp._asdict())
    assert tuple(tp) == tuple(jp)
