"""The PyTorch port's native (C++/libjpeg) loader: its copy of the C++ source
against the JAX package's, its decode against the JAX package's bit for bit
on JPEGs written from the synthetic scene, the prefetch queue's order and
errors, and the app's default mode reading a ``.jpg`` dataset through the
loader and a ``.png`` one through PIL."""

import hashlib
import os

import numpy as np
import pytest
import torch

from mvslam_tpu.io import native_loader as jloader
from mvslam_tpu_torch.apps import visual_odometer as app
from mvslam_tpu_torch.io import load_image_grayscale
from mvslam_tpu_torch.io import native_loader as tloader
from mvslam_tpu_torch.utils.scene import render_planes_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FOCAL = 240, 320, 280.0

needs_loader = pytest.mark.skipif(
    not tloader.available(),
    reason="native loader unavailable (no g++ or no libjpeg headers)")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The odometer on the CPU is thousands of tiny ops per frame: with the
    suite's workers side by side, torch's intra-op pool only makes them
    fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _below_header(path):
    with open(path) as f:
        lines = f.read().splitlines()
    first = next(i for i, line in enumerate(lines)
                 if not line.startswith("//"))
    return lines[first:]


def test_loader_source_equals_the_jax_package_copy():
    """Equal apart from the header comment, which names the port's module."""
    ours = _below_header(os.path.join(REPO, "mvslam_tpu_torch", "csrc",
                                      "loader.cpp"))
    theirs = _below_header(os.path.join(REPO, "native", "loader.cpp"))
    assert ours == theirs
    assert len(ours) > 150


@needs_loader
def test_library_is_built_into_build_keyed_by_the_source_hash():
    digest = hashlib.sha256(tloader._SOURCE.read_bytes()).hexdigest()[:16]
    so = tloader.BUILD_DIR / f"libmvslam_loader-{digest}.so"
    assert so.exists()
    assert tloader.BUILD_DIR.parts[-2:] == ("build", "native")
    assert not any(n.endswith(".so") for n in
                   os.listdir(tloader._SOURCE.parent))
    assert tloader.load_library() is tloader.load_library()


@pytest.fixture(scope="module")
def frames():
    n = 6
    i = np.arange(n)
    ts = np.stack([i * 0.12, 0.02 * np.sin(i * 0.25), np.zeros(n)], 1)
    return render_planes_sequence(ts, h=H, w=W, focal=FOCAL, bg_slope=0.18)


def _write(frames, directory, ext):
    from PIL import Image

    os.makedirs(directory, exist_ok=True)
    paths = []
    for k, img in enumerate(frames):
        p = os.path.join(directory, f"{k:03d}{ext}")
        arr = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        Image.fromarray(arr).save(p, quality=95)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory, frames):
    return _write(frames, str(tmp_path_factory.mktemp("jpg")), ".jpg")


@needs_loader
@pytest.mark.skipif(not jloader.available(),
                    reason="the JAX package's native loader is unavailable")
def test_decode_equals_the_jax_package_bitwise(jpegs):
    for p in jpegs:
        ours = tloader.decode_jpeg_gray(p)
        theirs = jloader.decode_jpeg_gray(p)
        assert ours.dtype == np.float32 and ours.shape == (H, W)
        np.testing.assert_array_equal(ours, theirs)
    # libjpeg's luma is not PIL's: the reason the app reads JPEGs natively
    pil = load_image_grayscale(jpegs[-1]).numpy()
    assert 0.0 < np.abs(ours - pil).mean() < 0.02


@needs_loader
@pytest.mark.parametrize("queue_depth,threads", [(2, 3), (4, 1)])
def test_prefetch_delivers_in_order(jpegs, queue_depth, threads):
    before = tloader.PrefetchLoader.delivered
    with tloader.PrefetchLoader(jpegs, queue_depth=queue_depth,
                                threads=threads) as it:
        got = list(it)
    assert [i for i, _ in got] == list(range(len(jpegs)))
    assert tloader.PrefetchLoader.delivered == before + len(jpegs)
    for (_, img), p in zip(got, jpegs):
        np.testing.assert_array_equal(img, tloader.decode_jpeg_gray(p))
        assert 0.0 <= img.min() and img.max() <= 1.0


@needs_loader
def test_missing_file_raises(jpegs):
    with pytest.raises(IOError):
        tloader.decode_jpeg_gray("/nonexistent/file.jpg")
    with tloader.PrefetchLoader([jpegs[0], "/nonexistent/file.jpg"]) as it:
        with pytest.raises(IOError):
            list(it)


@needs_loader
def test_frame_source_picks_the_loader_for_jpegs_only(tmp_path, frames,
                                                      jpegs):
    before = tloader.PrefetchLoader.delivered
    got = list(app.frame_source(jpegs))
    assert tloader.PrefetchLoader.delivered == before + len(jpegs)
    for t, p in zip(got, jpegs):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), tloader.decode_jpeg_gray(p))
    pngs = _write(frames, str(tmp_path / "png"), ".png")
    for paths in (pngs, jpegs[:2] + pngs[2:]):     # any non-JPEG: PIL
        got = list(app.frame_source(paths))
        assert tloader.PrefetchLoader.delivered == before + len(jpegs)
        for t, p in zip(got, paths):
            np.testing.assert_array_equal(t.numpy(),
                                          load_image_grayscale(p).numpy())


def _dataset(directory, paths):
    with open(os.path.join(directory, "camera.config"), "w") as f:
        f.write(f"{FOCAL} {FOCAL} 0 {(W - 1) / 2} {(H - 1) / 2}\n"
                "0 0 0 0 0 0\n")
    with open(os.path.join(directory, "image.txt"), "w") as f:
        f.write("\n".join(paths) + "\n")


@needs_loader
@pytest.mark.parametrize("ext", [".jpg", ".png"])
def test_app_default_mode_frame_source(tmp_path, frames, ext):
    """``main`` on a dataset: JPEG frames come through the prefetch loader
    (its count grows by the frames replayed), PNG frames through PIL."""
    ds = str(tmp_path / "ds")
    paths = _write(frames, ds, ext)
    _dataset(ds, paths)
    before = tloader.PrefetchLoader.delivered
    n = 4
    assert app.main([ds, "--device", "cpu", "--quiet", "--max-frames",
                     str(n)]) == 0
    delivered = tloader.PrefetchLoader.delivered - before
    assert delivered == (n if ext == ".jpg" else 0)
    assert os.path.getsize(os.path.join(ds, "trajectory.tum"))
