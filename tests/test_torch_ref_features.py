"""The JAX package's own feature bars, rerun on the port: the cases of
``tests/test_features.py`` that need no tsukuba frames, on
``mvslam_tpu_torch.ops.features`` (its plain corner front on the CPU) and
``mvslam_tpu_torch.ops.matching``. Float32 only, as the reference: the
port's ``orb_detect`` takes float32 (K1 and its plain version check it).

Each case builds the reference's synthetic image from the same numpy seed,
holds the port to the reference's bar, and compares it with the JAX
function on the same input. Descriptor words: uint32 in JAX, the same bits
as int32 in the port. (a) rerun here; (b) an existing test already asserts
the bar; (c) not applicable.

| reference case | | where |
|---|---|---|
| `test_features.py::test_fast_score_finds_corners` | a | `test_fast_score_finds_corners` |
| `test_features.py::test_box_sum_matches_naive` | a | `test_box_sum_matches_naive` |
| `test_features.py::test_orb_detect_shapes_and_masks` | a | `test_orb_detect_shapes_and_masks` |
| `test_features.py::test_orb_batched_layout_parity` | b | `test_torch_orb_options.py::test_batched_layout_equals_unrolled` (the same claim on a synthetic frame; the reference reads tsukuba) |
| `test_features.py::test_descriptor_stability_under_shift` | a | `test_descriptor_stability_under_shift` |
| `test_features.py::test_hamming_matrix_identities` | a | `test_hamming_matrix_identities` |
| `test_features.py::test_orb_pallas_dense_parity` (marked slow) | b | `test_torch_cuda.py::test_kernel_matches_plain_on_every_level` and `chip_smoke.py` `kernel vs plain` (K1 against its plain composition, on the card); `test_torch_features.py::test_rank_ref_matches_pallas_kernel_interpreted` (the plain composition against the Pallas kernel) |
| `test_features.py::TestTsukuba` (2) | c | tsukuba frames are absent |
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mvslam_tpu.ops import features as jf
from mvslam_tpu.ops import matching as jm
from mvslam_tpu_torch.ops import features, matching

from test_torch_ref_common import one_torch_thread  # noqa: F401 (autouse)

F32 = torch.float32
THRESHOLD = 20.0 / 255.0


def checkerboard(h=128, w=160, sq=16) -> np.ndarray:
    """``test_features.py::checkerboard``: isolated bright squares."""
    y = np.arange(h)[:, None] % (2 * sq)
    x = np.arange(w)[None, :] % (2 * sq)
    return ((y < sq) & (x < sq)).astype(np.float32)


def _jax_orb(img: np.ndarray, params: features.OrbParams):
    jp = jf.OrbParams(**{k: v for k, v in params._asdict().items()
                         if k in jf.OrbParams._fields})
    return jax.jit(jf.orb_detect, static_argnames=("params",))(
        jnp.asarray(img, jnp.float32), jp)


def _assert_same_features(t, j):
    """The port's features are JAX's: mask, keypoints, descriptor bits."""
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    sel = t.mask.numpy()
    np.testing.assert_array_equal(t.xy.numpy()[sel], np.asarray(j.xy)[sel])
    np.testing.assert_array_equal(
        t.desc.numpy()[sel], np.asarray(j.desc).view(np.int32)[sel])


def test_fast_score_finds_corners():
    img = checkerboard()
    score = features.nms3x3(features.fast_score(torch.from_numpy(img),
                                                THRESHOLD))
    assert int(torch.sum(score > 0)) >= 40
    flat = torch.full((64, 64), 0.5, dtype=F32)
    assert int(torch.sum(features.fast_score(flat, THRESHOLD) > 0)) == 0
    want = jf.nms3x3(jf.fast_score(jnp.asarray(img), THRESHOLD))
    np.testing.assert_array_equal(score.numpy(), np.asarray(want))


def test_box_sum_matches_naive():
    rng = np.random.default_rng(0)
    img = rng.uniform(size=(17, 23)).astype(np.float32)
    got = features._box_sum(torch.from_numpy(img), 2).numpy()
    padded = np.pad(img, 2)
    want = np.zeros((17, 23), np.float32)
    for i in range(17):
        for j in range(23):
            want[i, j] = padded[i: i + 5, j: j + 5].sum()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jf._box_sum(
        jnp.asarray(img), 2)), rtol=1e-5)


def test_orb_detect_shapes_and_masks():
    img = checkerboard(192, 256, 24)
    params = features.OrbParams(max_features=128)
    fs = features.orb_detect(torch.from_numpy(img), params)
    assert fs.xy.shape == (128, 2)
    assert fs.desc.shape == (128, 8) and fs.desc.dtype == torch.int32
    assert int(torch.sum(fs.mask)) >= 20
    xy = fs.xy.numpy()[fs.mask.numpy()]
    assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 256).all()
    assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 192).all()
    # against JAX: the board is binary and periodic, so (1) Harris ties
    # exactly between its corners and the packages' ~1e-6 summation-order
    # drift picks different ones at a level's budget, and (2) the
    # antialiased resize, 8.4e-6 apart between the packages at level 1,
    # moves resampled edge pixels across the FAST margin by the hundred.
    # So: the counts per level, level 0's sorted responses (the 1e-5 of
    # test_torch_features.py), and the corner maps bit-equal on each of
    # JAX's own levels (the divergence is the resize alone)
    j = _jax_orb(img, params)
    np.testing.assert_array_equal(fs.mask.numpy(), np.asarray(j.mask))
    sel = fs.mask.numpy()
    for lev in range(params.num_levels):
        got = fs.response.numpy()[sel & (fs.octave.numpy() == lev)]
        want = np.asarray(j.response)[sel & (np.asarray(j.octave) == lev)]
        assert got.shape == want.shape, lev
    got, want = (np.sort(r[sel & (o == 0)]) for r, o in (
        (fs.response.numpy(), fs.octave.numpy()),
        (np.asarray(j.response), np.asarray(j.octave))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * want.max())
    lev = jnp.asarray(img)
    for shape in jf._level_shapes(*img.shape, jf.OrbParams()):
        lev = jax.image.resize(lev, shape, "linear")     # orb_detect's chain
        want = jf.nms3x3(jf.fast_score(lev, THRESHOLD))
        got = features.nms3x3(features.fast_score(
            torch.from_numpy(np.array(lev)), THRESHOLD))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _shifted_pair():
    rng = np.random.default_rng(1)
    base = rng.uniform(size=(160, 200)).astype(np.float32)
    img_np = features._box_sum(torch.from_numpy(base), 2).numpy() / 25.0
    return (np.ascontiguousarray(img_np[8:136, 8:168]),
            np.ascontiguousarray(img_np[8 + 4: 136 + 4, 8 + 6: 168 + 6]))


def test_descriptor_stability_under_shift():
    img1, img2 = _shifted_pair()
    p = features.OrbParams(max_features=64, num_levels=3)
    f1 = features.orb_detect(torch.from_numpy(img1), p)
    f2 = features.orb_detect(torch.from_numpy(img2), p)
    m = matching.match_features(f1.desc, f1.mask, f2.desc, f2.mask,
                                max_distance=60)
    ok = m.mask.numpy()
    assert ok.sum() >= 10
    d = f2.xy.numpy()[m.idx.numpy()[ok]] - f1.xy.numpy()[ok]
    med = np.median(d, axis=0)
    assert abs(med[0] + 6) < 1.5 and abs(med[1] + 4) < 1.5
    j1, j2 = _jax_orb(img1, p), _jax_orb(img2, p)
    _assert_same_features(f1, j1)
    _assert_same_features(f2, j2)
    jmatch = jm.match_features(j1.desc, j1.mask, j2.desc, j2.mask,
                               max_distance=60)
    np.testing.assert_array_equal(ok, np.asarray(jmatch.mask))
    np.testing.assert_array_equal(m.idx.numpy()[ok],
                                  np.asarray(jmatch.idx)[ok])


def test_hamming_matrix_identities():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 2 ** 32, size=(16, 8), dtype=np.uint32)
    d = torch.from_numpy(a.view(np.int32))
    D = matching.hamming_matrix(d, d)
    assert D.shape == (16, 16)
    assert (torch.diagonal(D) == 0).all()
    Dc = matching.hamming_matrix(d, torch.bitwise_not(d))
    assert (torch.diagonal(Dc) == 256).all()
    want01 = bin(int(a[0, 0]) ^ int(a[1, 0])).count("1")
    total = sum(bin(int(a[0, k]) ^ int(a[1, k])).count("1") for k in range(8))
    assert int(D[0, 1]) == total and want01 <= total
    np.testing.assert_array_equal(
        D.numpy(), np.asarray(jm.hamming_matrix(jnp.asarray(a),
                                                jnp.asarray(a))))
