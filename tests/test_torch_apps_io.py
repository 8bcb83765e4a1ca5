"""The PyTorch port's app and its host-side copies.

The copies (``utils/errors``, ``io/image``, ``viz/export``,
``config.ParameterManager``, the camera's file format) against their
originals in the JAX package: same bytes written for the same input, same
arrays read. Then the port's ``visual_odometer`` app through ``main()`` on
a temporary dataset of PNG frames, on the CPU.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu import config as jconfig
from mvslam_tpu.io import image as jimage
from mvslam_tpu.math.lie import SE3 as JSE3
from mvslam_tpu.ops.camera import PinholeCamera as JCamera
from mvslam_tpu.utils.errors import ApplicationErrorCode as JErr
from mvslam_tpu.viz import export as jexport
from mvslam_tpu_torch import config as tconfig
from mvslam_tpu_torch.apps import visual_odometer as app
from mvslam_tpu_torch.io import image as timage
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops.camera import PinholeCamera
from mvslam_tpu_torch.utils.errors import ApplicationErrorCode
from mvslam_tpu_torch.utils.scene import render_planes_sequence
from mvslam_tpu_torch.viz import export as texport

H, W, FOCAL = 240, 320, 280.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The odometer on the CPU is thousands of tiny ops per frame: with the
    suite's workers side by side, torch's intra-op pool only makes them
    fight for the cores (measured: this file 4-40x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# copies against their originals
# ---------------------------------------------------------------------------


def test_error_codes_equal():
    assert {e.name: int(e) for e in ApplicationErrorCode} == {
        e.name: int(e) for e in JErr}


@pytest.mark.parametrize("shape", [(24, 32), (24, 32, 3)])
def test_image_io_equal(tmp_path, rng, shape):
    img = rng.uniform(-0.1, 1.1, shape).astype(np.float32)
    tp, jp = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    timage.save_image(tp, torch.from_numpy(img))
    jimage.save_image(jp, jnp.asarray(img))
    assert _bytes(tp) == _bytes(jp)
    timage.save_image(str(tmp_path / "a.png"), img)         # arrays too
    assert _bytes(str(tmp_path / "a.png")) == _bytes(jp)
    gray = timage.load_image_grayscale(jp)
    assert isinstance(gray, torch.Tensor) and gray.dtype == torch.float32
    assert gray.device.type == "cpu" and gray.shape == shape[:2]
    np.testing.assert_array_equal(gray.numpy(),
                                  np.asarray(jimage.load_image_grayscale(jp)))
    rgb = timage.load_image_rgb(jp)
    assert rgb.shape == shape[:2] + (3,)
    np.testing.assert_array_equal(rgb.numpy(),
                                  np.asarray(jimage.load_image_rgb(jp)))
    assert timage.load_image_grayscale(jp, torch.float64).dtype == torch.float64


def test_manifest_and_directory_listing_equal(tmp_path):
    d = tmp_path / "ds"
    (d / "sub").mkdir(parents=True)
    for name in ("b.jpg", "a.JPG", "c.png", "sub/x.jpg"):
        (d / name).write_bytes(b"")
    paths = [str(d / "b.jpg"), str(d / "sub" / "x.jpg"), "/abs/elsewhere.jpg"]
    tm, jm = str(d / "t.txt"), str(d / "j.txt")
    timage.write_manifest(tm, paths)
    jimage.write_manifest(jm, paths)
    assert _bytes(tm) == _bytes(jm)
    with open(tm, "a") as f:
        f.write("\n# a comment\n/abs/other.jpg\n")
    assert timage.read_manifest(tm) == jimage.read_manifest(tm)
    assert timage.read_manifest(tm)[-1] == "/abs/other.jpg"
    for ext in (".jpg", None):
        assert list(timage.iter_directory(str(d), ext)) == list(
            jimage.iter_directory(str(d), ext))
    assert [os.path.basename(p) for p in
            timage.iter_directory(str(d), ".jpg")] == ["a.JPG", "b.jpg"]


def _poses(rng, n=5):
    xi = rng.standard_normal((n, 6))
    xi[0] = 0.0
    xi[1, 3:] = [3.0, 0.3, -0.2]            # a trace-negative rotation
    T, J = SE3.exp(torch.tensor(xi)), JSE3.exp(jnp.asarray(xi))
    return ([(k, 0.1 * (k + 1), SE3(T.R[k], T.t[k])) for k in range(n)],
            [(k, 0.1 * (k + 1), JSE3(J.R[k], J.t[k])) for k in range(n)])


def test_trajectory_and_ply_exports_equal(tmp_path, rng):
    ttraj, jtraj = _poses(rng)
    tp, jp = str(tmp_path / "t.tum"), str(tmp_path / "j.tum")
    assert texport.save_trajectory_tum(tp, ttraj) == 5
    jexport.save_trajectory_tum(jp, jtraj)
    assert _bytes(tp) == _bytes(jp)
    back, jback = texport.load_trajectory_tum(tp), jexport.load_trajectory_tum(jp)
    assert [(b[0], b[1]) for b in back] == [(b[0], b[1]) for b in jback]
    for (_, _, p), (_, _, q), (_, _, orig) in zip(back, jback, ttraj):
        assert isinstance(p.R, torch.Tensor) and p.R.dtype == torch.float64
        np.testing.assert_array_equal(p.R.numpy(), np.asarray(q.R))
        np.testing.assert_array_equal(p.t.numpy(), np.asarray(q.t))
        np.testing.assert_allclose(p.R.numpy(), orig.R.numpy(), atol=1e-7)

    pts = rng.normal(size=(40, 3))
    colors = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    for name, targs, jargs in (
            ("cloud", (pts,), (pts,)),
            ("colored", (torch.from_numpy(pts), colors), (pts, colors))):
        tp, jp = str(tmp_path / f"t_{name}.ply"), str(tmp_path / f"j_{name}.ply")
        assert texport.save_point_cloud_ply(tp, *targs) == 40
        jexport.save_point_cloud_ply(jp, *jargs)
        assert _bytes(tp) == _bytes(jp)
    tp, jp = str(tmp_path / "t_scene.ply"), str(tmp_path / "j_scene.ply")
    n = texport.save_scene_ply(tp, torch.from_numpy(pts),
                               [p for _, _, p in ttraj])
    assert n == jexport.save_scene_ply(jp, pts, [p for _, _, p in jtraj])
    assert _bytes(tp) == _bytes(jp)


def test_overlays_equal(rng):
    img = rng.uniform(size=(48, 64)).astype(np.float32)
    xy = rng.uniform([2, 2], [60, 44], (12, 2))
    mask = rng.uniform(size=12) > 0.3
    np.testing.assert_array_equal(texport.draw_keypoints(img, xy, mask),
                                  jexport.draw_keypoints(img, xy, mask))
    idx = rng.permutation(12)
    inl = rng.uniform(size=12) > 0.5
    np.testing.assert_array_equal(
        texport.draw_matches(img, xy, img.T.copy().T, xy, idx, mask, inl),
        jexport.draw_matches(img, xy, img.T.copy().T, xy, idx, mask, inl))


def test_parameter_manager_equal(tmp_path):
    text = ("# comment\n[VisualOdometer]\nframe_queue_size = 10\n"
            "max_error = 0.5\n\n[ImagePair]\nrefine = false\nname = a b c\n"
            "big = 1e3\n[Empty]\n")
    src = tmp_path / "system.param"
    src.write_text(text)
    tpm, jpm = tconfig.ParameterManager(), jconfig.ParameterManager()
    assert tpm.load_from_file(str(src)) == jpm.load_from_file(str(src)) == 5
    assert tpm.module_count() == jpm.module_count() == 2
    assert tpm.variable_count() == jpm.variable_count()
    for module, key, default in (
            ("VisualOdometer", "frame_queue_size", 0),
            ("VisualOdometer", "max_error", 0.0), ("ImagePair", "refine", True),
            ("ImagePair", "name", ""), ("ImagePair", "big", 0),
            ("Nowhere", "nothing", 42)):
        got = tpm.get_value(module, key, default)
        assert got == jpm.get_value(module, key, default)
        assert type(got) is type(default)
    tpm.set_value("New", "x", 1.25)
    jpm.set_value("New", "x", 1.25)
    tp, jp = str(tmp_path / "t.param"), str(tmp_path / "j.param")
    assert tpm.save_to_file(tp) == jpm.save_to_file(jp)
    assert _bytes(tp) == _bytes(jp)
    for bad in ("x = 1\n", "[M]\nx = 1\nx = 2\n", "[M]\n[M]\n", "[M]\nnonsense\n"):
        src.write_text(bad)
        with pytest.raises(ValueError):
            tconfig.ParameterManager().load_from_file(str(src))
    with pytest.raises(ValueError):
        tconfig._convert("maybe", bool)
    # the module-level functions act on the global instance
    src.write_text(text)
    assert tconfig.load_from_file(str(src)) == 5
    assert tconfig.get_value("VisualOdometer", "max_error", 0.0) == 0.5
    assert tconfig.save_to_file(tp) == 5
    tconfig.ParameterManager.global_instance().clear()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_camera_file_format_equal(tmp_path, dtype):
    xi = np.array([0.3, -0.2, 0.5, 0.1, -0.25, 0.4])
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tcam = PinholeCamera.from_params(
        420.5, 415.25, 0.125, 310.0, 235.5,
        SE3.exp(torch.tensor(xi, dtype=tdt)), dtype=tdt)
    jcam = JCamera.from_params(
        420.5, 415.25, 0.125, 310.0, 235.5,
        JSE3.exp(jnp.asarray(xi, jdt)), dtype=jdt)
    tp, jp = str(tmp_path / "t.config"), str(tmp_path / "j.config")
    tcam.save_to_file(tp)
    jcam.save_to_file(jp)
    tv = np.array(open(tp).read().split(), np.float64)
    jv_ = np.array(open(jp).read().split(), np.float64)
    assert open(tp).read().count("\n") == 2 and tv.shape == (11,)
    np.testing.assert_array_equal(tv[:5], jv_[:5])
    np.testing.assert_allclose(tv[5:], jv_[5:], rtol=0,
                               atol=1e-6 if dtype == "float32" else 1e-14)
    got, want = PinholeCamera.load_from_file(jp, tdt), JCamera.load_from_file(
        jp, jdt)
    assert got.K.dtype == tdt and got.K.device.type == "cpu"
    np.testing.assert_array_equal(got.K.numpy(), np.asarray(want.K))
    np.testing.assert_allclose(got.P.matrix3x4().numpy(),
                               np.asarray(want.P.matrix3x4()), rtol=0,
                               atol=1e-6 if dtype == "float32" else 1e-14)


# ---------------------------------------------------------------------------
# the app
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """camera.config + image.txt + 10 PNG frames of the two-plane scene."""
    d = tmp_path_factory.mktemp("dataset")
    i = np.arange(10)
    ts = np.stack([i * 0.12, 0.02 * np.sin(i * 0.25), np.zeros(10)], 1)
    frames = render_planes_sequence(ts, h=H, w=W, focal=FOCAL, bg_slope=0.18)
    paths = []
    for k, frame in enumerate(frames):
        paths.append(str(d / f"{k:03d}.png"))
        timage.save_image(paths[-1], frame)
    timage.write_manifest(str(d / "image.txt"), paths)
    PinholeCamera.from_params(FOCAL, FOCAL, 0.0, (W - 1) / 2,
                              (H - 1) / 2).save_to_file(str(d / "camera.config"))
    (d / "system.param").write_text("[VisualOdometer]\nmax_error = 0.5\n")
    return d


def test_app_pose_graph_writes_its_files(dataset, tmp_path, capsys):
    rc = app.main([str(dataset), "--pose-graph", "--device", "cpu", "--quiet",
                   "--max-frames", "8", "--keyframe-every", "2",
                   "--out-dir", str(tmp_path / "out")])
    assert rc == ApplicationErrorCode.NONE
    stdout = capsys.readouterr().out
    assert "frame_total = 8, frame_tracked = 7, keyframes = 4" in stdout
    out = tmp_path / "out"
    raw = texport.load_trajectory_tum(str(out / "trajectory.tum"))
    opt = texport.load_trajectory_tum(str(out / "trajectory_optimized.tum"))
    assert len(raw) == len(opt) == 7
    assert [r[1] for r in raw] == pytest.approx([0.1 * (k + 1)
                                                 for k in range(1, 8)])
    # a loop-free skeleton: the optimized trajectory stays on the raw one
    for (_, _, p), (_, _, q) in zip(raw, opt):
        assert float((p.t - q.t).abs().max()) < 0.1
    # the tracker's unit is the bootstrap baseline: +x, one unit per frame
    assert float(raw[-1][2].t[0]) == pytest.approx(7.0, abs=0.5)
    header = (out / "scene.ply").read_text().splitlines()
    assert header[0] == "ply" and int(header[2].split()[-1]) > 7 * 24
    assert tconfig.get_value("VisualOdometer", "max_error", 0.0) == 0.5
    tconfig.ParameterManager.global_instance().clear()


def test_app_reports_frames_unless_quiet(dataset, tmp_path, capsys):
    rc = app.main([str(dataset), "--pose-graph", "--device", "cpu",
                   "--max-frames", "3", "--out-dir", str(tmp_path)])
    assert rc == ApplicationErrorCode.NONE
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 3 and err[0].startswith("frame 1 [000.png]: lost")
    assert "tracked inliers=" in err[2]
    tconfig.ParameterManager.global_instance().clear()


@pytest.mark.parametrize("extra,needle", [
    (["--pose-graph", "--checkpoint", "ck.npz"], "--checkpoint and --resume"),
    (["--pose-graph", "--resume", "ck.npz"], "--checkpoint and --resume"),
])
def test_app_refuses_what_it_cannot_do(dataset, capsys, extra, needle):
    rc = app.main([str(dataset), "--device", "cpu", *extra])
    assert rc == ApplicationErrorCode.INVALID_ARGS
    assert needle in capsys.readouterr().err


def test_app_default_mode_writes_its_files(dataset, tmp_path, capsys):
    """``FrameManager`` -> ``VisualOdometer`` over the ten frames: frame 1
    bootstraps, frame 2 fails the error gate, frame 3 bootstraps again, the
    rest are tracked."""
    out = tmp_path / "out"
    rc = app.main([str(dataset), "--device", "cpu", "--quiet",
                   "--out-dir", str(out)])
    assert rc == ApplicationErrorCode.NONE
    captured = capsys.readouterr()
    assert captured.err == ""
    assert "frame_total = 10, frame_tracked = 8, map_points = " in captured.out
    assert ", fps = " in captured.out and "wrote " in captured.out
    traj = texport.load_trajectory_tum(str(out / "trajectory.tum"))
    assert [r[1] for r in traj] == pytest.approx(
        [0.1 * (k + 1) for k in (1, 3, 4, 5, 6, 7, 8, 9)])
    # the unit is the second bootstrap's baseline: +x, one per frame
    assert float(traj[-1][2].t[0]) == pytest.approx(7.0, abs=0.7)
    header = (out / "scene.ply").read_text().splitlines()
    assert header[0] == "ply" and int(header[2].split()[-1]) > 8 * 24
    assert not (out / "trajectory_optimized.tum").exists()
    tconfig.ParameterManager.global_instance().clear()


def test_app_default_mode_reports_frames_unless_quiet(dataset, tmp_path,
                                                      capsys):
    rc = app.main([str(dataset), "--device", "cpu", "--max-frames", "3",
                   "--out-dir", str(tmp_path)])
    assert rc == ApplicationErrorCode.NONE
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 3
    assert err[0] == ("frame 1/3 [000.png]: lost (need frames) inliers=0 "
                      "t=None")
    assert err[1].startswith("frame 2/3 [001.png]: tracked (bootstrap) "
                             "inliers=")
    assert err[2].startswith("frame 3/3 [002.png]: lost (error gate)")
    tconfig.ParameterManager.global_instance().clear()


def test_app_checkpoint_then_resume_continues(dataset, tmp_path, capsys):
    """Six frames saved with ``--checkpoint``, the other four replayed with
    ``--resume``: the trajectory goes on where it stopped, with the poses
    of the run that never stopped."""
    whole, head, tail = (tmp_path / n for n in ("whole", "head", "tail"))
    ck = str(tmp_path / "ck.npz")
    assert app.main([str(dataset), "--device", "cpu", "--quiet",
                     "--out-dir", str(whole)]) == ApplicationErrorCode.NONE
    assert app.main([str(dataset), "--device", "cpu", "--quiet",
                     "--max-frames", "6", "--checkpoint", ck,
                     "--out-dir", str(head)]) == ApplicationErrorCode.NONE
    out = capsys.readouterr().out
    assert "frame_total = 6, frame_tracked = 4" in out
    assert f"wrote {ck}" in out and os.path.getsize(ck) > 0
    rest = tmp_path / "rest"
    rest.mkdir()
    paths = timage.read_manifest(str(dataset / "image.txt"))
    timage.write_manifest(str(rest / "image.txt"), paths[6:])
    (rest / "camera.config").write_text(
        (dataset / "camera.config").read_text())
    assert app.main([str(rest), "--device", "cpu", "--quiet", "--resume", ck,
                     "--out-dir", str(tail)]) == ApplicationErrorCode.NONE
    assert "frame_total = 10, frame_tracked = 8" in capsys.readouterr().out
    want = texport.load_trajectory_tum(str(whole / "trajectory.tum"))
    got = texport.load_trajectory_tum(str(tail / "trajectory.tum"))
    assert len(got) == len(want) == 8
    assert len(texport.load_trajectory_tum(str(head / "trajectory.tum"))) == 4
    for (_, _, p), (_, _, q) in zip(got, want):
        assert torch.equal(p.t, q.t) and torch.equal(p.R, q.R)
    tconfig.ParameterManager.global_instance().clear()


def test_app_error_codes_for_bad_datasets(tmp_path, capsys):
    args = ["--pose-graph", "--device", "cpu", "--quiet"]
    assert app.main([str(tmp_path), *args]) == ApplicationErrorCode.INVALID_ARGS
    (tmp_path / "camera.config").write_text("1 2 three\n")
    assert app.main([str(tmp_path), *args]) == ApplicationErrorCode.BAD_IO
    (tmp_path / "image.txt").write_text("nowhere.png\n")
    assert app.main([str(tmp_path), *args]) == ApplicationErrorCode.BAD_DATA
    assert "bad camera config" in capsys.readouterr().err
