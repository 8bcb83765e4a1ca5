"""What the KITTI deployment's counters read (``slambench/counters.py``),
on the CPU, with the configuration's ``orb`` and ``vo`` settings cut to a
quarter (features, map slots, BA points) and its camera to half its size
on each side, over the first frames of the benchmark's ``forward`` mix:
the state's ``lf_mask`` holds the frame's own keypoints within the budget
on every branch, the step's own BA (``counters.BATap``) runs once on each
TRACKING frame and nowhere else, its robust share (``ba.huber_share``) is a share and is 0
without the Huber delta, and the poses stay rotations."""

import numpy as np
import pytest
import torch

from mvslam_tpu_torch.frontend import vo_jit
from mvslam_tpu_torch.ops import ba
from slambench import cell as bench_cell
from slambench import counters, program, reference, scene

from test_torch_ref_common import one_torch_thread  # noqa: F401

FRAMES, SEED = 12, 1_900_000_019
#: the configuration's camera at half its size on each side
CAMERA = {"width": 620, "height": 188, "fx": 359.428, "fy": 359.428,
          "cx": 303.6, "cy": 92.6}


def _config(huber: bool) -> dict:
    c = bench_cell.load_json(bench_cell.ROOT / "slambench" / "configs"
                             / "kitti-orbslam2-mono.json")
    vo = dict(c["vo"])
    for k in ("map_capacity", "ba_old", "ba_new"):
        vo[k] //= 4
    if not huber:
        vo["huber_delta"] = None
    orb = dict(c["orb"], max_features=c["orb"]["max_features"] // 4)
    return dict(c, camera=CAMERA, orb=orb, vo=vo)


@pytest.fixture(scope="module")
def images():
    cam = bench_cell.camera_of(_config(True))
    spec = bench_cell.load_json(bench_cell.BENCH_DIR / "traffic"
                                / "forward.json")
    ts, yaws = bench_cell.generate(spec)
    u8 = torch.empty((FRAMES, cam.height, cam.width), dtype=torch.uint8)
    scene.render_uint8(torch.Generator().manual_seed(SEED), ts[:FRAMES],
                       yaws[:FRAMES], cam, float(spec.get("bg_slope", 0.0)),
                       u8)
    return cam, reference.to_image(u8)


def _run(images, huber: bool, monkeypatch):
    """Per frame: the entering mode, the step's output, the state's kept
    keypoints, the feature half's own, and the BA problems and results
    the step solved."""
    cam, frames = images
    config = _config(huber)
    trk = program.tracker(config, cam.K(), "cpu")
    tap = counters.BATap(vo_jit.ba_mod)
    monkeypatch.setattr(vo_jit, "ba_mod", tap)
    state = trk.init_state(7)
    rows = []
    for t in range(FRAMES):
        entry = int(state.mode)
        tap.solved.clear()
        own = int(trk.pre(frames[t], trk.K_inv, trk.focal)[0].mask.sum())
        state, out = trk.step(state, frames[t], trk.K_inv, trk.focal)
        rows.append((entry, out, int(state.lf_mask.sum()), own,
                     list(tap.solved)))
    return trk.params, rows


def _share(solved, params):
    (prob, _, res), = solved
    r = ba.huber_share(res.poses, res.points, prob, params.huber_delta)
    assert r.shape == ()
    return float(r)


@pytest.fixture(scope="module")
def huber_run(images):
    with pytest.MonkeyPatch.context() as mp:
        return _run(images, True, mp)


def test_keypoints_kept_within_the_budget(huber_run):
    params, rows = huber_run
    assert params.orb.max_features == 500 and params.huber_delta == 2.4477
    for entry, out, stored, own, _ in rows:
        assert 0 < stored <= params.orb.max_features
        # every branch stores the frame's own features
        assert stored == own


def test_robust_share_is_a_share_on_tracked_frames(huber_run):
    params, rows = huber_run
    tracking = [r for r in rows if r[0] == vo_jit.MODE_TRACKING]
    assert len(tracking) >= 5
    for entry, out, _, _, solved in rows:
        if entry != vo_jit.MODE_TRACKING:
            assert not solved
            continue
        assert solved[0][0].points0.shape[0] == params.ba_old + params.ba_new
        assert 0.0 <= _share(solved, params) <= 1.0


def test_poses_stay_rotations(huber_run):
    _, rows = huber_run
    for _, out, _, _, _ in rows:
        R = out.pose_R.double().numpy()
        np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-4)
        assert np.isfinite(out.pose_t.numpy()).all()


def test_robust_share_zero_without_the_delta(images, monkeypatch):
    params, rows = _run(images, False, monkeypatch)
    assert params.huber_delta is None
    tracking = [r for r in rows if r[0] == vo_jit.MODE_TRACKING]
    assert len(tracking) >= 5
    for _, _, stored, own, solved in tracking:
        assert _share(solved, params) == 0.0
        assert 0 < stored == own <= params.orb.max_features
