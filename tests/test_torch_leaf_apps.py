"""The PyTorch port's remaining apps against the JAX package's, on the CPU:
calibrate-camera on one directory of chessboard images rendered with numpy
(OpenCV detects the corners for both), reconstruct-scene on one synthetic
pair (each package held to the scene's truth), the four demos, and
video-capture without a camera; then the apps' ``--device`` defaults."""

import os
import re

import numpy as np
import pytest
import torch

from mvslam_tpu.apps import calibrate_camera as jcal
from mvslam_tpu.apps import demos as jdemos
from mvslam_tpu.apps import reconstruct_scene as jrec
from mvslam_tpu.apps import video_capture as jvid
from mvslam_tpu_torch.apps import calibrate_camera as tcal
from mvslam_tpu_torch.apps import demos as tdemos
from mvslam_tpu_torch.apps import reconstruct_scene as trec
from mvslam_tpu_torch.apps import video_capture as tvid
from mvslam_tpu_torch.ops import features_cuda
from mvslam_tpu_torch.utils.errors import ApplicationErrorCode
from mvslam_tpu_torch.utils.scene import render_planes_sequence

#: the bench scene: frames 0 and 4 of its 110-frame path
H, W, FOCAL = 288, 384, 300.0
#: the recovered pair against the scene's truth (rad)
MAX_ROT_ERR = 1e-2
MAX_DIR_ERR = 5e-2
#: calibrate-camera, both packages on the same detections: K relative
CALIB_RTOL = 1e-6
#: visual-feature match counts, port against JAX
MATCH_RTOL = 0.05


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Thousands of tiny torch ops per call: with the suite's workers side
    by side, torch's intra-op pool only makes them fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _save_png(path, img):
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)).save(
        path)


# ---------------------------------------------------------------------------
# calibrate-camera
# ---------------------------------------------------------------------------

#: the chessboard images: 9x6 inner corners at 640x480, square size 1
BOARD_ROWS, BOARD_COLS = 6, 9
CAL_K = np.array([[520.0, 0.0, 318.0], [0.0, 515.0, 243.0], [0.0, 0.0, 1.0]])


def render_chessboard(R, t, h=480, w=640, ss=3) -> np.ndarray:
    """A (h, w) image of the board (squares of 1, inner corners at the
    integer points 0..8 x 0..5, a one-square white margin) on a gray
    background, seen through ``CAL_K`` from world->camera ``(R, t)``;
    ``ss`` x ``ss`` samples per pixel."""
    Hb = CAL_K @ np.stack([R[:, 0], R[:, 1], t], 1)     # board plane -> image
    Hinv = np.linalg.inv(Hb)
    off = (np.arange(ss) + 0.5) / ss - 0.5
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    acc = np.zeros((h, w))
    for dy in off:
        for dx in off:
            p = np.stack([xs + dx, ys + dy, np.ones_like(xs, float)], -1)
            q = p @ Hinv.T
            bx, by = q[..., 0] / q[..., 2], q[..., 1] / q[..., 2]
            sq = (np.floor(bx) + np.floor(by)) % 2 == 0
            inside = ((bx >= -1) & (bx < BOARD_COLS) & (by >= -1)
                      & (by < BOARD_ROWS))
            margin = ((bx >= -2) & (bx < BOARD_COLS + 1) & (by >= -2)
                      & (by < BOARD_ROWS + 1))
            acc += np.where(inside, np.where(sq, 0.05, 0.95),
                            np.where(margin, 0.95, 0.5))
    return (acc / (ss * ss)).astype(np.float32)


def _rot(rx, ry, rz):
    from mvslam_tpu_torch.math.lie import so3_exp

    return so3_exp(torch.tensor([rx, ry, rz], dtype=torch.float64)).numpy()


@pytest.fixture(scope="module")
def chessboards(tmp_path_factory):
    d = tmp_path_factory.mktemp("boards")
    rng = np.random.default_rng(7)
    centre = np.array([(BOARD_COLS - 1) / 2, (BOARD_ROWS - 1) / 2, 0.0])
    for v in range(5):
        R = _rot(*rng.uniform(-0.35, 0.35, 2), rng.uniform(-0.2, 0.2))
        t = -R @ centre + np.array([rng.uniform(-1, 1), rng.uniform(-1, 1),
                                    15.0 + 1.5 * v])
        _save_png(str(d / f"view{v}.png"), render_chessboard(R, t))
    return str(d)


def _numbers(path):
    with open(path) as f:
        return np.array([float(v) for v in f.read().split()])


def test_calibrate_camera_app_equals_jax(chessboards, tmp_path, capsys):
    pytest.importorskip("cv2")
    out = {}
    for name, mod, extra in (("jax", jcal, []),
                             ("port", tcal, ["--device", "cpu"])):
        cfg = str(tmp_path / f"{name}.config")
        png = str(tmp_path / f"{name}_und.png")
        rc = mod.main([chessboards, cfg, "--extension", ".png",
                       "--undistort-preview", png, *extra])
        cap = capsys.readouterr()
        assert rc == ApplicationErrorCode.NONE, cap.err
        out[name] = dict(
            corners=re.findall(r": (\d+) corners", cap.err),
            K=cap.out[cap.out.index("K ="):cap.out.index("rms")],
            cam=_numbers(cfg), png=png,
            lines=[ln for ln in cap.out.splitlines()
                   if ln.startswith(("rms", "radial"))])
    j, t = out["jax"], out["port"]
    assert j["corners"] == t["corners"] == ["54"] * 5
    assert t["K"] == j["K"]                        # the printed digits
    assert t["lines"] == j["lines"]
    np.testing.assert_allclose(t["cam"], j["cam"], rtol=CALIB_RTOL,
                               atol=CALIB_RTOL * 520.0)
    # and the camera is the one the images were rendered with
    fx, fy, shear, px, py = t["cam"][:5]
    assert abs(fx - 520.0) < 5.0 and abs(fy - 515.0) < 5.0, t["cam"]
    assert abs(px - 318.0) < 5.0 and abs(py - 243.0) < 5.0, t["cam"]
    from PIL import Image

    a = np.asarray(Image.open(t["png"]), np.float64)
    b = np.asarray(Image.open(j["png"]), np.float64)
    assert a.shape == (480, 640) and np.abs(a - b).max() <= 1.0


def test_calibrate_views_matches_planar_solve():
    """``calibrate_views`` is ``calibrate_planar`` on float64 board points
    in the detector's row-major order."""
    R = _rot(0.2, -0.1, 0.05)
    views = []
    board = tcal.board_points(BOARD_ROWS, BOARD_COLS, 0.5)
    for k in range(4):
        Rk = _rot(0.25 * np.cos(k), 0.25 * np.sin(k), 0.0) @ R
        X = np.concatenate([board, np.zeros((len(board), 1))], 1)
        Xc = X @ Rk.T + np.array([-2.0, -1.2, 9.0 + k])
        views.append(Xc[:, :2] / Xc[:, 2:] @ CAL_K[:2, :2].T + CAL_K[:2, 2])
    res, cam, und = tcal.calibrate_views(views, BOARD_ROWS, BOARD_COLS, 0.5,
                                         device="cpu")
    assert und is None and res.dist is None
    assert cam.K.dtype == torch.float64
    np.testing.assert_allclose(cam.K.numpy(), CAL_K, atol=1e-6)
    assert float(res.rms_error) < 1e-6


# ---------------------------------------------------------------------------
# reconstruct-scene
# ---------------------------------------------------------------------------


def _bench_pair():
    n = 110
    i = np.arange(n)
    ts = np.stack([i * 0.12, 0.03 * np.sin(i * 0.25), np.zeros(n)], 1)
    frames = render_planes_sequence(ts, h=H, w=W, focal=FOCAL)
    return frames[0], frames[4], ts[4] - ts[0]


@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair")
    a, b, _ = _bench_pair()
    _save_png(str(d / "a.png"), a)
    _save_png(str(d / "b.png"), b)
    (d / "camera.config").write_text(
        f"{FOCAL} {FOCAL} 0 {(W - 1) / 2} {(H - 1) / 2}\n0 0 0 0 0 0\n")
    return str(d)


def _vector(text, label):
    line = next(ln for ln in text.splitlines() if ln.startswith(label))
    return np.array([float(v) for v in
                     line[line.index("[") + 1:line.index("]")].split()])


def truth_errors(t, w, baseline):
    """(rotation angle, angle between t and the true baseline) in rad."""
    d = baseline / np.linalg.norm(baseline)
    cos = float(np.dot(t, d) / np.linalg.norm(t))
    return float(np.linalg.norm(w)), float(np.arccos(np.clip(cos, -1, 1)))


@pytest.mark.parametrize("package", ["jax", "port"])
def test_reconstruct_scene_app_holds_to_truth(pair_dir, tmp_path, capsys,
                                              package):
    _, _, baseline = _bench_pair()
    mod, extra = (jrec, []) if package == "jax" else (trec, ["--device", "cpu"])
    out_dir = str(tmp_path / package)
    rc = mod.main([os.path.join(pair_dir, "a.png"),
                   os.path.join(pair_dir, "b.png"),
                   os.path.join(pair_dir, "camera.config"),
                   "--out-dir", out_dir, *extra])
    text = capsys.readouterr().out
    assert rc == ApplicationErrorCode.NONE
    rot, ang = truth_errors(_vector(text, "pose2in1 translation"),
                            _vector(text, "pose2in1 rotation"), baseline)
    assert rot < MAX_ROT_ERR and ang < MAX_DIR_ERR, (rot, ang)
    inliers = int(re.search(r"match inliers: (\d+)", text).group(1))
    points = int(re.search(r"triangulated points: (\d+)", text).group(1))
    assert inliers >= 100 and points >= 100
    for f in ("reconstruction.ply", "matches.png"):
        assert os.path.getsize(os.path.join(out_dir, f)), f


def test_reconstruct_function_launch_free_on_the_cpu(tmp_path):
    """The app's function with the frames in memory: the pair, the PLY and
    the overlay; on CPU tensors no kernel launch is counted."""
    from mvslam_tpu_torch.ops.camera import PinholeCamera

    a, b, baseline = _bench_pair()
    cam = PinholeCamera.from_params(FOCAL, FOCAL, 0.0, (W - 1) / 2,
                                    (H - 1) / 2)
    before = features_cuda.fast_nms_harris_rank_pyramid.launches
    rec = trec.reconstruct(torch.from_numpy(a), torch.from_numpy(b), cam,
                           str(tmp_path), device="cpu")
    assert features_cuda.fast_nms_harris_rank_pyramid.launches == before
    T = rec.pair.T_pair_to_base
    rot, ang = truth_errors(T.t.double().numpy(),
                            T.log()[3:].double().numpy(), baseline)
    assert rot < MAX_ROT_ERR and ang < MAX_DIR_ERR
    assert rec.overlay.shape == (H, 2 * W, 3)
    with open(rec.ply) as f:
        assert f"element vertex" in f.read(200)
    assert rec.num_points == int(rec.pair.result.point_mask.sum())


# ---------------------------------------------------------------------------
# demos and video-capture
# ---------------------------------------------------------------------------


DEMOS = {
    "image-io": (["a.png"], ["roundtrip.png"]),
    "visual-feature": (["a.png", "b.png"], ["matches.png"]),
    "visualizer-2d": (["a.png", "b.png"],
                      ["view2d.png", "view2d_00001.png", "view2d_00002.png",
                       "matches.png"]),
    "visualizer-3d": ([], ["scene.ply", "view3d.png"]),
}


@pytest.mark.parametrize("demo", sorted(DEMOS))
def test_demo_writes_its_files(pair_dir, tmp_path, capsys, demo):
    if demo == "visualizer-3d":
        pytest.importorskip("matplotlib")
    inputs, files = DEMOS[demo]
    counts = {}
    for name, mod, extra in (("jax", jdemos, []),
                             ("port", tdemos, ["--device", "cpu"])):
        out = str(tmp_path / name)
        rc = mod.main([demo, *(os.path.join(pair_dir, p) for p in inputs),
                       out, *extra])
        text = capsys.readouterr().out
        assert rc == ApplicationErrorCode.NONE
        for f in files:
            assert os.path.getsize(os.path.join(out, f)), (name, f)
        m = re.search(r"features: (\d+)/(\d+) matches: (\d+)", text)
        if m:
            counts[name] = [int(g) for g in m.groups()]
    if demo in ("visual-feature", "visualizer-2d"):
        j, t = counts["jax"], counts["port"]
        assert t[:2] == j[:2]
        assert abs(t[2] - j[2]) <= MATCH_RTOL * j[2], (t, j)
    if demo == "image-io":
        assert "roundtrip_max_err=0.0000" in text


def test_demos_refuse_wrong_arguments():
    assert tdemos.main(["image-io", "only-one"]) == jdemos.main(
        ["image-io", "only-one"]) == ApplicationErrorCode.INVALID_ARGS


def test_video_capture_without_a_camera(tmp_path):
    """No camera here: both packages return the same code (HARDWARE_ERROR,
    with or without cv2)."""
    args = [str(tmp_path / "cap"), "--count", "1", "--interval-ms", "0",
            "--device", "97"]
    assert tvid.main(args) == jvid.main(args) == (
        ApplicationErrorCode.HARDWARE_ERROR)
    assert not os.path.exists(tmp_path / "cap" / "image.txt")


# ---------------------------------------------------------------------------
# --device defaults
# ---------------------------------------------------------------------------


def test_reconstruct_scene_defaults_to_the_card(monkeypatch, pair_dir):
    seen = []
    monkeypatch.setattr(trec, "reconstruct",
                        lambda *a, device, **kw: seen.append(device))
    trec.main([os.path.join(pair_dir, "a.png"),
               os.path.join(pair_dir, "b.png"),
               os.path.join(pair_dir, "camera.config")])
    assert seen == ["cuda"]


def test_calibrate_camera_defaults_to_the_card(monkeypatch, pair_dir,
                                               tmp_path):
    seen = []
    monkeypatch.setattr(tcal, "find_chessboard",
                        lambda *a: np.zeros((54, 2)))

    def fake(*a, device, **kw):
        seen.append(device)
        raise SystemExit(0)

    monkeypatch.setattr(tcal, "calibrate_views", fake)
    for name in ("x.png", "y.png", "z.png"):
        _save_png(str(tmp_path / name), np.zeros((8, 8)))
    with pytest.raises(SystemExit):
        tcal.main([str(tmp_path), str(tmp_path / "c.config"),
                   "--extension", ".png"])
    assert seen == ["cuda"]


@pytest.mark.parametrize("demo,fn", [("visual-feature", "demo_visual_feature"),
                                     ("visualizer-2d", "demo_visualizer_2d"),
                                     ("visualizer-3d", "demo_visualizer_3d")])
def test_demos_default_to_the_card(monkeypatch, tmp_path, demo, fn):
    seen = []
    monkeypatch.setattr(tdemos, fn, lambda *a: seen.append(a[-1]) or 0)
    args = [] if demo == "visualizer-3d" else ["a.png", "b.png"]
    assert tdemos.main([demo, *args, str(tmp_path)]) == 0
    assert seen == ["cuda"]
