"""The PyTorch port's host-side leaf modules against the JAX package's:
strings, directory listing, logging, the host clock, the spans' null
context, the synchronisation primitives, and both threaded viewers (the
JAX package's own cases of ``tests/test_utils.py`` and ``tests/test_viz.py``
rerun on the port, plus side-by-side comparisons)."""

import contextlib
import io
import os
import threading
import time

import numpy as np
import pytest
import torch

from mvslam_tpu.utils import fs as jfs
from mvslam_tpu.utils import logging as jlogging
from mvslam_tpu.utils import strings as jstrings
from mvslam_tpu_torch import utils as tutils
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.utils import fs, strings, timing
from mvslam_tpu_torch.utils import logging as tlogging
from mvslam_tpu_torch.utils.sync import Event, Lock, Mutex
from mvslam_tpu_torch.viz import (
    Visualizer2d, Visualizer2dParams, Visualizer3d, Visualizer3dParams,
)

# ---------------------------------------------------------------------------
# strings (tests/test_utils.py:41-67 on the port)
# ---------------------------------------------------------------------------


def test_string_trim_and_case():
    assert strings.string_trim_whitespaces("  ab c \t\n") == "ab c"
    assert strings.string_to_upper("aBc") == "ABC"
    assert strings.string_to_lower("aBc") == "abc"
    assert strings.string_is_alphabet("abc")
    assert not strings.string_is_alphabet("ab1")
    assert not strings.string_is_alphabet("")


@pytest.mark.parametrize(
    "s,ok",
    [("3.25", True), ("-1e-3", True), ("42", True), ("  7.0  ", True),
     ("abc", False), ("", False), ("inf", False), ("nan", False)],
)
def test_string_is_scalar(s, ok):
    assert strings.string_is_scalar(s) == ok


def test_convert_to_bool_reference_semantics():
    assert strings.convert_to_bool("TRUE") is True
    assert strings.convert_to_bool("false") is False
    assert strings.convert_to_bool("1.5") is True
    assert strings.convert_to_bool("0") is False
    assert strings.convert_to_bool("-3") is False
    assert strings.string_is_boolean("TRUE")
    assert strings.string_is_boolean("0.5")
    assert not strings.string_is_boolean("maybe")
    with pytest.raises(ValueError):
        strings.convert_to_bool("maybe")


SAMPLES = ["", " ", "abc", "AbC", " x y ", "3", "-2.5e3", "+.5", "1e", "inf",
           "NaN", "TRUE", "false", " True ", "0", "-0.0", "maybe", "12a",
           "\t7\n"]


@pytest.mark.parametrize("name", [
    "string_trim_whitespaces", "string_to_upper", "string_to_lower",
    "string_is_alphabet", "string_is_scalar", "string_is_boolean",
    "convert_to_bool"])
def test_strings_equal_the_jax_package(name):
    ours, theirs = getattr(strings, name), getattr(jstrings, name)
    for s in SAMPLES:
        try:
            want = ("ok", theirs(s))
        except ValueError:
            want = ("raises", None)
        try:
            got = ("ok", ours(s))
        except ValueError:
            got = ("raises", None)
        assert got == want, s


# ---------------------------------------------------------------------------
# fs, logging, timing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ext", ["", "jpg", ".JPG", "png"])
def test_fs_equals_the_jax_package(tmp_path, ext):
    for name in ("b.jpg", "a.JPG", "c.png", "d", "e.jpeg"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "sub.jpg").mkdir()
    assert fs.list_directory(str(tmp_path), ext) == jfs.list_directory(
        str(tmp_path), ext)
    assert list(fs.iterate_directory(str(tmp_path), ext)) == list(
        jfs.iterate_directory(str(tmp_path), ext))
    assert "sub.jpg" not in fs.list_directory(str(tmp_path), ext)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_logging_equals_the_jax_package(level):
    out = {}
    for key, mod in (("port", tlogging), ("jax", jlogging)):
        streams = [io.StringIO() for _ in range(3)]
        saved = (mod.Logging._level, mod.Logging._debug_stream,
                 mod.Logging._info_stream, mod.Logging._error_stream)
        try:
            mod.Logging.set_logging_level(mod.LoggingLevel(level))
            mod.Logging.set_streams(*streams)
            assert mod.Logging.get_logging_level() == level
            log = mod.Logger("tag")
            off = mod.Logger("off", enabled=False)
            for lg in (log, off):
                lg.debug("d", 1)
                lg.info("i", 2.5)
                lg.error("e", None)
            mod.Logging.error("bare")
        finally:
            (mod.Logging._level, mod.Logging._debug_stream,
             mod.Logging._info_stream, mod.Logging._error_stream) = saved
        out[key] = [s.getvalue() for s in streams]
    assert out["port"] == out["jax"]
    assert [int(e) for e in tlogging.LoggingLevel] == [
        int(e) for e in jlogging.LoggingLevel]


def test_utils_package_exports():
    assert tutils.Logger is tlogging.Logger
    assert tutils.Logging is tlogging.Logging
    assert (tutils.Event, tutils.Lock, tutils.Mutex) == (Event, Lock, Mutex)


def test_clock_counts_from_import():
    t0, u0 = timing.get_time_ms(), timing.get_time_us()
    timing.sleep_ms(5)
    assert timing.get_time_ms() >= t0 + 4 and timing.get_time_us() > u0
    assert isinstance(t0, int) and isinstance(u0, int)
    for name in ("cuda_ms", "graph_ms", "sync_sites"):     # kept
        assert callable(getattr(timing, name))


def test_span_without_a_profiler_is_the_shared_null_context():
    a, b = timing.span("vo_jit.pre"), timing.span("vo_jit.track.ba")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        with b:                 # re-entered: it holds no state
            pass


# ---------------------------------------------------------------------------
# sync primitives and viewers (tests/test_viz.py on the port)
# ---------------------------------------------------------------------------


def _wait_for(path, timeout=20.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if os.path.exists(path) and os.path.getsize(path) > 0:
            return True
        time.sleep(0.05)
    return False


def test_mutex_is_recursive():
    m = Mutex()
    with m:
        with m:
            pass
    with Lock(m):
        pass


def test_event_trigger_all_wakes_all_waiters():
    ev = Event()
    woke = []

    def waiter(i):
        ev.wait()
        woke.append(i)

    threads = [threading.Thread(target=waiter, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    ev.trigger_all()
    for t in threads:
        t.join(timeout=5.0)
    assert sorted(woke) == [0, 1, 2, 3]


def test_event_wait_timeout():
    ev = Event()
    t0 = time.time()
    assert not ev.wait_timeout(100)
    assert time.time() - t0 < 5.0
    ev.trigger_all()
    # a trigger before the wait is not consumed retroactively
    assert not ev.wait_timeout(50)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_visualizer3d_renders_scene(tmp_path, kind):
    pytest.importorskip("matplotlib")
    v = Visualizer3d(str(tmp_path), Visualizer3dParams(view_cadence_ms=20))
    rng = np.random.default_rng(0)
    cloud = rng.normal(size=(50, 3))
    if kind == "numpy":
        v.set_point_cloud(0, cloud)
        v.set_camera_pose(0, SE3(np.eye(3), np.zeros(3)))
        v.set_camera_pose(1, SE3(np.eye(3), np.array([1.0, 0, 0])))
    else:
        v.set_point_cloud(0, torch.tensor(cloud, dtype=torch.float32))
        v.set_camera_pose(0, SE3.identity())
        v.set_camera_pose(1, SE3(torch.eye(3), torch.tensor([1.0, 0, 0])))
    assert _wait_for(v.window_path)
    assert not v.is_window_closed()
    v.close()
    assert v.is_window_closed()
    assert not v._thread.is_alive()
    from PIL import Image

    img = Image.open(v.window_path)
    assert img.size[0] > 100 and img.size[1] > 100


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_visualizer2d_keyframe_and_pair(tmp_path, kind):
    v = Visualizer2d(str(tmp_path), Visualizer2dParams(redraw_timeout_ms=20))
    img = np.zeros((64, 80), np.float32)
    xy = np.array([[10.0, 10.0], [40.0, 30.0], [70.0, 50.0]])
    idx, mm, im = (np.array([0, 1, 2]), np.array([True, True, False]),
                   np.array([True, False, False]))
    if kind == "tensor":
        img, xy, idx, mm, im = (torch.from_numpy(a)
                                for a in (img, xy, idx, mm, im))
    v.show_keyframe(img, xy)
    assert _wait_for(v.window_path)
    v.show_matched_pair(img, xy, img, xy, idx, mm, inlier_mask=im)
    v.close()
    assert not v._thread.is_alive()
    files = sorted(os.listdir(tmp_path))
    assert [f for f in files if f.startswith("view2d_")] == [
        "view2d_00001.png", "view2d_00002.png"]
    from PIL import Image

    pair = np.asarray(Image.open(os.path.join(tmp_path, files[-1])))
    assert pair.shape == (64, 160, 3)
    assert (pair[..., 1] > 200).any()          # the inlier drawn green


def test_visualizer2d_draws_what_the_jax_viewer_draws(tmp_path):
    """Same inputs through both packages' 2D viewers: the same PNGs."""
    from mvslam_tpu.viz import Visualizer2d as JVisualizer2d

    rng = np.random.default_rng(5)
    img = rng.uniform(size=(48, 64)).astype(np.float32)
    xy = rng.uniform([0, 0], [63, 47], (12, 2))
    mask = rng.uniform(size=12) > 0.3
    idx = rng.permutation(12)
    for name, cls in (("port", Visualizer2d), ("jax", JVisualizer2d)):
        v = cls(str(tmp_path / name))
        v.show_keyframe(img, xy, mask)
        v.show_matched_pair(img, xy, img[::-1].copy(), xy, idx, mask,
                            mask[::-1].copy())
        v.close()
    for f in ("view2d_00001.png", "view2d_00002.png", "view2d.png"):
        with open(tmp_path / "port" / f, "rb") as a, \
                open(tmp_path / "jax" / f, "rb") as b:
            assert a.read() == b.read(), f
