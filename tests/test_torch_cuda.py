"""The PyTorch port on the card. Its CUDA kernel: both wrappers against the
plain version at the tracker's pyramid shapes, the pyramid call's views
against per-level calls, the wrappers' checks and launch count, and the
tracker's steps on the device. Its SLAM path: the back-end, the sparse BA
and the float64 graph solve, each against the same code on the CPU fed the
same inputs. Its host-orchestrated front end (``FrameManager`` ->
``VisualOdometer``): the devices it sits on, the kernel launched once per
frame, the card against the CPU under the same draws, the checkpoint round
trip, and the writes through repeating indices. The remaining entry points:
the calibration solve, its preview and the homographies against the CPU,
the reconstruct-scene solve's two kernel launches, and the 2D viewer fed
tensors on the card. The ORB options (one kernel launch per image, the
batched layout equal to the unrolled one, subpixel against the CPU) and
the distributed solvers on a one-rank NCCL group (bitwise the ungrouped
solves). The two-view, PnP and BA solves of the reference's rigs in
float64 and float32. The tracker's CUDA graphs against its op-by-op step,
bit for bit: the geometry stages, the feature half after K1 (one
capture per image shape and ORB layout, K1 still one eager launch a frame
that the benchmark's tap sees, outputs that outlive the next replay) and
the bootstrap's slot and refine chains (the refits' ``eigh`` calls eager
between replays, the refine walk's fallback and slide, one capture per
chain kept across the reset, given draws, state that outlives the next
bootstrap); the same at the KITTI cell's size (1241x376, 2,000 features,
4,096 map slots, a BA over 1,536 + 512 points, the Huber kernel on).
Every test needs a CUDA card
and skips without one; this file imports no JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from mvslam_tpu_torch import convert
from mvslam_tpu_torch.backend import pose_graph as pg
from mvslam_tpu_torch.backend.slam import BackendParams, PoseGraphBackend
from mvslam_tpu_torch.frontend import FrameManager, VisualOdometer
from mvslam_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from mvslam_tpu_torch.math import kalman
from mvslam_tpu_torch.ops.camera import PinholeCamera
from mvslam_tpu_torch.utils.indexing import set_rows
from mvslam_tpu_torch.frontend import vo_jit
from mvslam_tpu_torch.frontend.vo_jit import (
    VoJitParams, make_vo_step, vo_init_state,
)
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops import ba_sparse, features, features_cuda
from mvslam_tpu_torch.parallel.synthetic import make_sequence_ba_problem
from mvslam_tpu_torch.utils.scene import render_planes_sequence

pytestmark = pytest.mark.cuda

P = features.OrbParams()
#: Harris on corners, relative to the level's max |Harris|: direct 7-tap
#: sums in the kernel against cumsum differences in the plain version
HARRIS_RTOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _levels(dev, h=288, w=384):
    ts = np.zeros((1, 3))
    img = torch.from_numpy(render_planes_sequence(ts, h=h, w=w,
                                                  focal=300.0)[0]).to(dev)
    return features.pyramid(img, P)


ARGS = (P.fast_threshold, P.harris_k, P.border)
SIZES = [(288, 384), (480, 640), (100, 70)]


def _assert_matches_plain(k, lv):
    r = features_cuda.fast_nms_harris_rank_ref(lv, *ARGS)
    fin = torch.isfinite(r)
    assert torch.equal(torch.isfinite(k), fin), tuple(lv.shape)
    if fin.any():
        scale = float(r[fin].abs().max())
        assert float((k[fin] - r[fin]).abs().max()) <= HARRIS_RTOL * scale


@pytest.mark.parametrize("size", SIZES)
def test_kernel_matches_plain_on_every_level(dev, size):
    for lv in _levels(dev, *size):
        k = features_cuda.fast_nms_harris_rank(lv, *ARGS)
        torch.cuda.synchronize()
        _assert_matches_plain(k, lv)


@pytest.mark.parametrize("size", SIZES)
def test_pyramid_call_matches_plain_on_every_level(dev, size):
    levels = _levels(dev, *size)
    ranks = features_cuda.fast_nms_harris_rank_pyramid(levels, *ARGS)
    torch.cuda.synchronize()
    assert len(ranks) == len(levels)
    for lv, k in zip(levels, ranks):
        assert k.shape == lv.shape and k.is_contiguous()
        _assert_matches_plain(k, lv)


@pytest.mark.parametrize("size", SIZES)
def test_pyramid_views_equal_per_level_calls_bitwise(dev, size):
    levels = _levels(dev, *size)
    ranks = features_cuda.fast_nms_harris_rank_pyramid(levels, *ARGS)
    for lv, k in zip(levels, ranks):
        assert torch.equal(k, features_cuda.fast_nms_harris_rank(lv, *ARGS))


def test_unaligned_level_pointer_takes_the_scalar_load(dev):
    """A level whose first pixel is not 16-byte aligned (a view one float
    into a buffer) gives the same map as its aligned copy."""
    lv = _levels(dev)[0]
    buf = torch.empty(lv.numel() + 1, device=dev)
    shifted = buf[1:].view_as(lv).copy_(lv)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    assert torch.equal(features_cuda.fast_nms_harris_rank(shifted, *ARGS),
                       features_cuda.fast_nms_harris_rank(lv, *ARGS))


def test_kernel_counts_launches(dev):
    """One launch per call of either wrapper, however many levels."""
    levels = _levels(dev)
    before = features_cuda.fast_nms_harris_rank_pyramid.launches
    features_cuda.fast_nms_harris_rank_pyramid(levels, *ARGS)
    assert features_cuda.fast_nms_harris_rank_pyramid.launches == before + 1
    features_cuda.fast_nms_harris_rank(levels[0], *ARGS)
    assert features_cuda.fast_nms_harris_rank_pyramid.launches == before + 2


def test_pyramid_launch_is_captured_in_a_cuda_graph(dev):
    """The launch is on the current stream and synchronises nothing, so a
    CUDA graph takes it; a replay on new pixels gives the eager maps."""
    levels = _levels(dev)
    static = [lv.clone() for lv in levels]
    features_cuda.fast_nms_harris_rank_pyramid(static, *ARGS)   # build, load
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ranks = features_cuda.fast_nms_harris_rank_pyramid(static, *ARGS)
    for s in static:
        s.copy_(s.flip(1))
    graph.replay()
    torch.cuda.synchronize()
    for s, k in zip(static, ranks):
        assert torch.equal(k, features_cuda.fast_nms_harris_rank(s, *ARGS))


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "3d"])
def test_wrapper_rejects_what_the_kernel_does_not_take(dev, bad):
    lv = _levels(dev)[0]
    x = {"float64": lv.double(), "non_contiguous": lv.t(),
         "3d": lv[None]}[bad]
    with pytest.raises(ValueError):
        features_cuda.fast_nms_harris_rank(x, *ARGS)
    with pytest.raises(ValueError):
        features_cuda.fast_nms_harris_rank_pyramid([lv, x], *ARGS)


def test_tracker_steps_on_the_card(dev):
    params = VoJitParams()
    ts = np.stack([np.arange(3) * 0.12, np.zeros(3), np.zeros(3)], 1)
    frames = torch.from_numpy(render_planes_sequence(ts, h=288, w=384,
                                                     focal=300.0)).to(dev)
    K_inv = torch.tensor(np.linalg.inv(np.asarray(
        [[300.0, 0, 191.5], [0, 300.0, 143.5], [0, 0, 1]])),
        dtype=torch.float32, device=dev)
    step = make_vo_step(params)
    state = vo_init_state(params, device=dev)
    before = features_cuda.fast_nms_harris_rank_pyramid.launches
    modes = []
    for t in range(3):
        state, out = step(state, frames[t], K_inv, 300.0)
        modes.append(int(out.mode))
    assert features_cuda.fast_nms_harris_rank_pyramid.launches == before + 3
    assert modes == [1, 2, 2]
    assert bool(torch.isfinite(state.pose_t).all())


def test_backend_on_the_card_matches_cpu(dev):
    """14 frames out and back (every tracked frame a keyframe, loops after
    a gap of 3): the tracker runs once on the card, and a back-end on the
    card and one on the CPU get the same snapshots and the same uniforms."""
    h, w, focal = 240, 320, 280.0
    x = np.concatenate([np.arange(7), 6 - np.arange(7)]) * 0.12
    ts = np.stack([x, 0.02 * np.sin(np.arange(14) * 0.25), np.zeros(14)], 1)
    frames = render_planes_sequence(ts, h=h, w=w, focal=focal, bg_slope=0.18)
    K_inv = torch.tensor(np.linalg.inv(np.asarray(
        [[focal, 0, (w - 1) / 2], [0, focal, (h - 1) / 2], [0, 0, 1]])),
        dtype=torch.float32, device=dev)
    params = VoJitParams()
    step = make_vo_step(params)
    state = vo_init_state(params, device=dev)
    bp = BackendParams(keyframe_every=1, min_loop_gap=3)
    card = PoseGraphBackend(bp, focal=focal, device=dev)
    cpu = PoseGraphBackend(bp, focal=focal, device="cpu")
    rng = np.random.default_rng(7)
    for i in range(14):
        state, out = step(state, torch.from_numpy(frames[i]).to(dev), K_inv,
                          focal)
        u = torch.tensor(rng.uniform(size=(2, 2, bp.loop_hypotheses,
                                           params.orb.max_features)))
        a = card.add_frame(i, state, out, uniforms=u.to(dev))
        b = cpu.add_frame(
            i, convert.state_from_numpy(convert.state_to_numpy(state),
                                        device="cpu"),
            convert.step_out_from_numpy(convert.step_out_to_numpy(out),
                                        device="cpu"), uniforms=u)
        assert a == b, i
    assert card._desc.is_cuda and card._lm.shape[0] == bp.max_keyframes
    assert [k.frame_idx for k in card.keyframes] == [
        k.frame_idx for k in cpu.keyframes]
    assert len(card.keyframes) >= 10
    assert len(card.loop_edges) >= 3
    for ce, pe in zip(card.loop_edges, cpu.loop_edges):
        assert ce[:2] == pe[:2] and abs(ce[3] - pe[3]) <= 2
        span = max(float(pe[2].t.norm()), 1.0)
        # float32 resection + BA polish, reductions in another order
        assert float((ce[2].t - pe[2].t).abs().max()) <= 2e-3 * span
    # the float64 graphs on one skeleton agree closely
    same = convert.backend_from_numpy(convert.backend_to_numpy(cpu), bp,
                                      focal=focal, device=dev)
    for method in ("sim3", "se3"):
        got, want = same.optimize(method=method), cpu.optimize(method=method)
        assert got.t.is_cuda and got.t.dtype == torch.float64
        assert float((got.t.cpu() - want.t).abs().max()) <= 1e-6
    got = same.correct_trajectory(same.optimize())
    want = cpu.correct_trajectory(cpu.optimize())
    for (gi, _, gt), (wi, _, wt) in zip(got, want):
        assert gi == wi and np.abs(gt - wt).max() <= 1e-6


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-3),
                                       (torch.float64, 1e-8)])
def test_sparse_ba_on_the_card_matches_cpu(dev, dtype, tol):
    """One seeded sequence problem on both devices (identical inputs);
    poses relative to the 16-unit span, cost relative."""
    kw = dict(num_frames=32, points_per_frame=16, window=4, dtype=dtype)
    params = ba_sparse.SparseBAParams(max_iterations=8, cg_iterations=30)
    on_card, _, _ = make_sequence_ba_problem(3, device=dev, **kw)
    on_cpu, _, _ = make_sequence_ba_problem(3, device="cpu", **kw)
    assert torch.equal(on_card.obs.cpu(), on_cpu.obs)
    got = ba_sparse.sparse_ba_solve(on_card, params)
    want = ba_sparse.sparse_ba_solve(on_cpu, params)
    c0 = float(ba_sparse._cost(on_cpu.poses0, on_cpu.points0, on_cpu))
    assert float(want.error) < 0.05 * c0 and float(got.error) < 0.05 * c0
    assert abs(float(got.error) - float(want.error)) <= tol * (
        1.0 + float(want.error))
    assert float((got.poses.t.cpu() - want.poses.t).abs().max()) <= tol * 16


def _ring_graph():
    """A noisy 12-node ring with one closing edge, float64, on the CPU."""
    rng = np.random.default_rng(11)
    n = 12
    th = 2 * np.pi * np.arange(n) / n
    xi = np.stack([3 * np.cos(th), 3 * np.sin(th), 0 * th, 0 * th, 0 * th,
                   th + np.pi / 2], 1)
    true = SE3.exp(torch.tensor(xi))
    noisy = true.compose(SE3.exp(torch.tensor(
        0.05 * rng.standard_normal((n, 6)))))
    src = torch.arange(n)
    dst = (src + 1) % n
    rel = SE3(true.R[src], true.t[src]).inverse().compose(
        SE3(true.R[dst], true.t[dst]))
    prior_info = torch.zeros((n, 6, 6), dtype=torch.float64)
    prior_info[0] = torch.eye(6, dtype=torch.float64) / pg.ORIGIN_STDDEV ** 2
    return pg.PoseGraphData(
        noisy, torch.ones(n, dtype=torch.bool), src, dst, rel,
        (100.0 * torch.eye(6, dtype=torch.float64)).expand(n, 6, 6).clone(),
        torch.ones(n, dtype=torch.bool), noisy, prior_info)


def test_float64_graph_solve_on_the_card(dev):
    """A noisy 12-node ring with one closing edge, float64: the card and
    the CPU take the same LM iterations to the same optimum."""
    data = _ring_graph()
    src, dst, rel = data.edge_src, data.edge_dst, data.edge_rel
    on_card = convert.pose_graph_data_from_numpy(
        convert.problem_to_numpy(data), device=dev)
    assert on_card.poses.t.is_cuda and on_card.poses.t.dtype == torch.float64
    got, want = pg.pose_graph_optimize(on_card), pg.pose_graph_optimize(data)
    assert int(got.iterations) == int(want.iterations)
    assert bool(got.converged) and bool(want.converged)
    assert float(want.error) < 1e-3 * float(pg.pose_graph_cost(data))
    assert float((got.poses.t.cpu() - want.poses.t).abs().max()) <= 1e-7
    # the exact measurements pull the ring back onto the truth (node 0 is
    # anchored at its noisy start, so compare relative poses)
    est = SE3(got.poses.R[src], got.poses.t[src]).inverse().compose(
        SE3(got.poses.R[dst], got.poses.t[dst]))
    assert float((est.t.cpu() - rel.t).abs().max()) <= 1e-6


# -- the host-orchestrated front end ---------------------------------------


def _scene(n=6, h=240, w=320, focal=280.0):
    # the renderer sizes its textures by the whole path: ten frames, cut
    i = np.arange(10)
    ts = np.stack([i * 0.12, 0.02 * np.sin(i * 0.25), np.zeros(10)], 1)
    frames = render_planes_sequence(ts, h=h, w=w, focal=focal,
                                    bg_slope=0.18)[:n]
    return frames, PinholeCamera.from_params(focal, focal, 0.0, (w - 1) / 2,
                                             (h - 1) / 2)


def _uniforms(rng, dev):
    return torch.tensor(rng.uniform(size=(256, P.max_features)),
                        dtype=torch.float32, device=dev)


def test_front_end_sits_on_the_card_by_default(dev):
    frames, cam = _scene(1)
    fm, vo = FrameManager(camera=cam), VisualOdometer()
    assert fm.device.type == vo.device.type == "cuda"
    assert fm.camera.K.is_cuda and vo._map.positions.is_cuda
    before = features_cuda.fast_nms_harris_rank_pyramid.launches
    frame = fm.add_frame(0.1, frames[0])
    assert features_cuda.fast_nms_harris_rank_pyramid.launches == before + 1
    for t in (frame.rays, frame.sigma, frame.image, frame.image_smooth,
              frame.features.desc, frame.features.mask):
        assert t.is_cuda
    assert fm._fps._state.x.device.type == "cpu"     # by design
    assert fm.get_fps() == 0.0
    # the same keypoints as the CPU's plain corner front
    want = FrameManager(camera=cam, device="cpu").add_frame(0.1, frames[0])
    assert torch.equal(frame.features.mask.cpu(), want.features.mask)
    m = want.features.mask
    assert int(m.sum()) > 300
    got_xy = {tuple(p) for p in frame.features.xy.cpu()[m].tolist()}
    want_xy = {tuple(p) for p in want.features.xy[m].tolist()}
    assert len(got_xy ^ want_xy) <= 6      # resize rounding moves a rank tie


def test_host_vo_on_the_card_matches_cpu(dev):
    """Six frames through ``FrameManager`` -> ``VisualOdometer`` on the
    card and on the CPU under the same uniforms: equal outcomes, inlier
    counts within 3, one kernel launch per frame, poses within 0.1 of the
    distance travelled (unit: the baseline) and 5e-3. This odometer's
    tracked poses are loose across the path (+-0.3 baselines in both
    packages) and amplify the devices' rounding accordingly: measured 0.11
    at 2 baselines out, where its bootstrap poses agree to 1e-2."""
    frames, cam = _scene(6)
    sides = [(FrameManager(camera=cam), VisualOdometer()),
             (FrameManager(camera=cam, device="cpu"),
              VisualOdometer(device="cpu"))]
    rng = np.random.default_rng(5)
    before = features_cuda.fast_nms_harris_rank_pyramid.launches
    tracked = 0
    for k, img in enumerate(frames):
        u = _uniforms(rng, "cpu")
        a, b = (vo.add_frame(fm.add_frame(0.1 * (k + 1), img),
                             uniforms=u.to(vo.device)) for fm, vo in sides)
        assert (a.success, a.reason) == (b.success, b.reason), k
        assert abs(a.num_inliers - b.num_inliers) <= 3, k
        if a.success:
            tracked += 1
            assert a.pose.t.is_cuda
            reach = max(1.0, float(b.pose.t.norm()))
            assert float((a.pose.t.cpu() - b.pose.t).abs().max()) <= (
                0.1 * reach)
            assert float((a.pose.R.cpu() - b.pose.R).abs().max()) <= 5e-3
    assert tracked >= 3
    assert features_cuda.fast_nms_harris_rank_pyramid.launches == before + 6
    card = sides[0][1]
    assert card._last_obs_rays.is_cuda
    assert card._last_obs_rays.dtype == torch.float64
    assert abs(card.num_tracked_points - sides[1][1].num_tracked_points) <= 10


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """Saved on the card after a bootstrap, loaded on the card (bit-equal
    next frame) and on the CPU (the same outcome)."""
    frames, cam = _scene(3)
    fm, vo = FrameManager(camera=cam), VisualOdometer()
    rng = np.random.default_rng(6)
    for k in range(2):
        vo.add_frame(fm.add_frame(0.1 * (k + 1), frames[k]),
                     uniforms=_uniforms(rng, dev))
    assert vo.state.name == "TRACKING"
    path = str(tmp_path / "vo.npz")
    save_checkpoint(vo, path)
    back = load_checkpoint(path, VisualOdometer())
    on_cpu = load_checkpoint(path, VisualOdometer(device="cpu"))
    assert back._map.positions.is_cuda and not on_cpu._map.positions.is_cuda
    assert torch.equal(back._map.positions, vo._map.positions)
    assert torch.equal(back._map.desc, vo._map.desc)
    frame = fm.add_frame(0.3, frames[2])
    u = _uniforms(rng, dev)
    a, b = vo.add_frame(frame, uniforms=u), back.add_frame(frame, uniforms=u)
    assert a[2:] == b[2:] and a.success == b.success
    if a.success:
        assert torch.equal(a.pose.t, b.pose.t)
    c = on_cpu.add_frame(
        FrameManager(camera=cam, device="cpu").add_frame(0.3, frames[2]),
        uniforms=u.cpu())
    assert (c.success, c.reason) == (a.success, a.reason)


def test_set_rows_with_repeats_is_deterministic_on_the_card(dev):
    """Repeated indices on the card: numpy's last write, every time."""
    rng = np.random.default_rng(8)
    n, k = 64, 4096
    idx = rng.integers(0, n, k)
    vals = rng.normal(size=(k, 3)).astype(np.float32)
    want = np.zeros((n, 3), np.float32)
    want[idx] = vals
    dst = torch.zeros((n, 3), device=dev)
    for _ in range(5):
        got = set_rows(dst, torch.tensor(idx, device=dev),
                       torch.tensor(vals, device=dev))
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    filled = set_rows(dst, torch.tensor(idx[:5], device=dev), 2.0)
    assert float(filled.sum()) == 2.0 * 3 * len(set(idx[:5].tolist()))


def test_kalman_follows_its_inputs_device(dev):
    x = torch.zeros(2, device=dev, dtype=torch.float64)
    eye = torch.eye(2, device=dev, dtype=torch.float64)
    state, ok = kalman.kf_process_update(kalman.kf_init(x, eye), eye,
                                         0.1 * eye)
    state, ok2 = kalman.kf_measurement_update(
        state, eye[:1], torch.ones(1, device=dev, dtype=torch.float64),
        eye[:1, :1])
    assert state.x.is_cuda and state.P.is_cuda and bool(ok) and bool(ok2)
    cpu = kalman.kf_measurement_update(
        kalman.kf_process_update(kalman.kf_init(x.cpu(), eye.cpu()),
                                 eye.cpu(), 0.1 * eye.cpu())[0],
        eye[:1].cpu(), torch.ones(1, dtype=torch.float64),
        eye[:1, :1].cpu())[0]
    assert float((state.x.cpu() - cpu.x).abs().max()) <= 1e-12


def test_calibration_on_the_card_equals_the_cpu(dev):
    """``calibrate_planar`` with distortion and ``undistort_image`` in
    float64 on the card against the CPU on the same views."""
    from mvslam_tpu_torch.math.lie import so3_exp
    from mvslam_tpu_torch.ops import calibration, homography

    rng = np.random.default_rng(9)
    K = np.array([[420.0, 0.0, 310.0], [0.0, 415.0, 235.0], [0, 0, 1.0]])
    gx, gy = np.meshgrid(np.arange(9), np.arange(6))
    board = np.stack([gx.ravel(), gy.ravel()], -1) * 0.1
    board = board - board.mean(0)
    X = np.concatenate([board, np.zeros((54, 1))], 1)
    views = []
    for v in range(8):
        R = so3_exp(torch.tensor(rng.uniform(-0.35, 0.35, 3))).numpy()
        Xc = X @ R.T + np.array([0.04 * v - 0.14, 0.0, 0.8 + 0.08 * v])
        xy = Xc[:, :2] / Xc[:, 2:]
        r2 = (xy * xy).sum(-1, keepdims=True)
        xy = xy * (1 - 0.25 * r2 + 0.08 * r2 * r2)
        views.append(xy @ K[:2, :2].T + K[:2, 2] + rng.normal(0, 0.05, (54, 2)))
    args = [torch.tensor(a) for a in (board, np.stack(views),
                                      np.ones((8, 54)))]
    img = torch.tensor(rng.uniform(size=(120, 160)))
    out = {}
    for d in (dev, torch.device("cpu")):
        res = calibration.calibrate_planar(
            *(a.to(d) for a in args), refine_iterations=60,
            estimate_distortion=True)
        und = calibration.undistort_image(img.to(d), res.K / 3.0, res.dist)
        H = homography.find_homography(*(a.to(d) for a in (
            args[0].expand(8, 54, 2), args[1], args[2])))
        out[d.type] = [t.cpu() for t in (res.K, res.dist, und, H)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-9 * max(
            float(b.abs().max()), 1.0)
    assert abs(float(out["cuda"][1][0]) + 0.25) < 0.02


def test_reconstruct_launches_twice_on_the_card(dev, tmp_path):
    from mvslam_tpu_torch.apps.reconstruct_scene import reconstruct

    i = np.arange(5)
    ts = np.stack([i * 0.12, 0.03 * np.sin(i * 0.25), np.zeros(5)], 1)
    frames = render_planes_sequence(ts, h=288, w=384, focal=300.0)
    cam = PinholeCamera.from_params(300.0, 300.0, 0.0, 191.5, 143.5)
    features_cuda.fast_nms_harris_rank_pyramid.launches = 0
    rec = reconstruct(torch.from_numpy(frames[0]), torch.from_numpy(frames[4]),
                      cam, str(tmp_path), device=dev)
    assert features_cuda.fast_nms_harris_rank_pyramid.launches == 2
    assert rec.pair.T_pair_to_base.t.is_cuda and rec.num_points > 100
    t = rec.pair.T_pair_to_base.t.cpu().double().numpy()
    base = ts[4] - ts[0]
    assert float(t @ base / np.linalg.norm(t) / np.linalg.norm(base)) > 0.99


def test_viewer_takes_card_tensors(dev, tmp_path):
    pytest.importorskip("PIL")
    from mvslam_tpu_torch.viz import Visualizer2d

    img = torch.rand(48, 64, device=dev)
    xy = torch.tensor([[5.0, 5.0], [30.0, 20.0]], device=dev)
    v = Visualizer2d(str(tmp_path))
    v.show_keyframe(img, xy, torch.ones(2, dtype=torch.bool, device=dev))
    v.show_matched_pair(img, xy, img, xy, torch.arange(2, device=dev),
                        torch.ones(2, dtype=torch.bool, device=dev))
    v.close()
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("view2d_")
                  ) == ["view2d_00001.png", "view2d_00002.png"]


@pytest.mark.parametrize("subpixel", [False, True])
def test_orb_batched_layout_equals_unrolled_on_the_card(dev, subpixel):
    """One K1 launch per image in each layout; the same features but for
    the angles' summation order."""
    img = _levels(dev)[0]
    got = []
    for batched in (False, True):
        before = features_cuda.fast_nms_harris_rank_pyramid.launches
        got.append(features.orb_detect(img, P._replace(batched=batched,
                                                       subpixel=subpixel)))
        assert features_cuda.fast_nms_harris_rank_pyramid.launches == \
            before + 1
    fu, fb = got
    m = fu.mask
    assert torch.equal(fb.mask, m) and torch.equal(fb.octave, fu.octave)
    assert torch.equal(fb.xy[m], fu.xy[m]) and torch.equal(fb.desc[m],
                                                           fu.desc[m])
    assert float((fb.angle[m] - fu.angle[m]).abs().max()) <= 1e-6


@pytest.mark.parametrize("batched", [False, True])
def test_orb_subpixel_on_the_card_matches_cpu(dev, batched):
    """From the same pyramid: the same keypoints, the subpixel positions
    within 1e-4 px of their level (the fit reads a float64 Harris
    surface on both devices)."""
    levels = _levels(dev, 480, 640)
    p = P._replace(batched=batched, subpixel=True)

    def detect(lv):
        return features.orb_keypoints(lv, features.corner_ranks(lv, p), p)

    card = detect(levels)
    cpu = detect([lv.cpu() for lv in levels])
    m = cpu.mask
    assert torch.equal(card.mask.cpu(), m)
    assert torch.equal(card.octave.cpu(), cpu.octave)
    scale = (P.scale_factor ** cpu.octave[m].double())[:, None]
    assert float(((card.xy.cpu()[m] - cpu.xy[m]).double() / scale)
                 .abs().max()) <= 1e-4


def test_distributed_solvers_on_one_nccl_rank_equal_the_ungrouped(dev):
    """A one-rank NCCL group formed in this process: the sparse solve and
    both graphs bitwise equal to the ungrouped solves."""
    import torch.distributed as dist

    from mvslam_tpu_torch import parallel
    from mvslam_tpu_torch.backend import sim3_graph as sg
    from mvslam_tpu_torch.parallel import dist_ba_sparse, dist_pose_graph

    if dist.is_initialized():
        pytest.skip("a process group is already initialised")
    mesh = parallel.make_mesh("cuda")
    try:
        assert dist.get_backend() == "nccl"
        prob, _, _ = make_sequence_ba_problem(0, num_frames=16,
                                              points_per_frame=8,
                                              dtype=torch.float64)
        params = ba_sparse.SparseBAParams(max_iterations=6, cg_iterations=20)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            a = ba_sparse.sparse_ba_solve(prob, params)
            b = dist_ba_sparse.distributed_sparse_ba_solve(prob, mesh, params)
        finally:
            torch.use_deterministic_algorithms(False)
        assert torch.equal(a.poses.t, b.poses.t)
        assert torch.equal(a.points, b.points)
        assert int(a.iterations) == int(b.iterations)
        data = convert.pose_graph_data_from_numpy(
            convert.problem_to_numpy(_ring_graph()), device=dev)
        a = pg.pose_graph_optimize(data)
        b = dist_pose_graph.distributed_pose_graph_optimize(data, mesh)
        assert torch.equal(a.poses.t, b.poses.t)
        sim3 = sg.Sim3GraphData(
            sg.Sim3(torch.ones(data.poses.t.shape[0], dtype=torch.float64,
                               device=dev), data.poses.R, data.poses.t),
            data.node_mask, data.edge_src, data.edge_dst,
            sg.Sim3(torch.ones(data.edge_src.shape[0], dtype=torch.float64,
                               device=dev), data.edge_rel.R, data.edge_rel.t),
            _info7(data.edge_info), data.edge_mask,
            sg.Sim3(torch.ones(data.poses.t.shape[0], dtype=torch.float64,
                               device=dev), data.prior_pose.R,
                    data.prior_pose.t), _info7(data.prior_info))
        a = sg.sim3_graph_optimize(sim3)
        b = dist_pose_graph.distributed_sim3_graph_optimize(sim3, mesh)
        assert torch.equal(a.poses.t, b.poses.t)
        assert torch.equal(a.poses.s, b.poses.s)
    finally:
        dist.destroy_process_group()


def _info7(info6):
    """A 7x7 information with the 6x6 block and unit scale information."""
    out = torch.zeros(info6.shape[:-2] + (7, 7), dtype=info6.dtype,
                      device=info6.device)
    out[..., :6, :6] = info6
    out[..., 6, 6] = 1.0
    return out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_reference_rigs_solve_on_the_card(dev, dtype):
    """``tests/test_sfm.py`` / ``test_ba.py``'s two-view, PnP and BA solves
    of the cube and L rigs on the card, within the reference's ``tol_for``
    of truth. The float32 refit of the cube rig's exact rays made
    cuSOLVER's eigh report no convergence, and torch raised there before
    the port's ``linalg.eigh`` (JAX's NaN instead, refit dropped)."""
    import chip_smoke as cs

    rng = np.random.default_rng(5)
    uniforms = {"sfm": rng.uniform(size=(256, 16)),
                "pnp": rng.uniform(size=(256, 8))}
    tol = cs.GEOM_TOL[dtype]
    for rig in cs.RIGS.values():
        for solver, (e_pose, e_pts, _) in cs.geometry_errors(
                dev, dtype, rig, uniforms).items():
            assert e_pose < tol and e_pts < 10 * tol, solver


# -- the 8-point DLT solver on the card -------------------------------------

@pytest.mark.parametrize("which", ["two", "one"])
def test_dlt_solver_on_the_card_spans_eigh_subspace(dev, which):
    """On the card (cuBLAS's products) the solvers span float64 eigh's
    bottom subspace where float32 resolves it, within chip_smoke's bound
    (the CPU's own case: tests/test_torch_ref_math.py)."""
    import chip_smoke as cs

    M32 = cs.separated_psd(which)
    k = 2 if which == "two" else 1
    ref = np.linalg.eigh(M32.astype(np.float64))[1][..., :k]
    got = cs.solve_spans(torch.from_numpy(M32).to(dev))[which]
    assert cs.span_angle(got, ref).max() < cs.SOLVER_EIGH_ANGLE[which]


# -- the TRACKING branch's geometry stages as CUDA graphs ---------------------

#: the benchmark's scene: frames of the tsukuba.track cell from one seed;
#: frame ``BLANK`` is black, which loses track (a reset to INITIALIZING)
GRAPH_FRAMES, GRAPH_SEED, BLANK = 40, 2_900_000_303, 26


def _bits(t):
    return t.detach().reshape(-1).view(torch.uint8)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        _bits(a), _bits(b))


def _fields(state, out):
    """(name, tensor) of a step's state and output, the generator's state
    included."""
    got = [(f"state.{k}", v.get_state() if isinstance(v, torch.Generator)
            else v) for k, v in state._asdict().items()]
    return got + [(f"out.{k}", v) for k, v in out._asdict().items()]


def _cell_scene(workload):
    """A cell's tracker params, K_inv, focal (a tensor, as the benchmark
    passes it) and its first ``GRAPH_FRAMES`` frames as the served loop
    hands them over, frame ``BLANK`` black."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from slambench import cell as bench_cell
    from slambench import program, reference, scene

    dev = torch.device("cuda", 0)
    c = bench_cell.resolve(workload)
    tr = c.traffic
    u8 = torch.empty((GRAPH_FRAMES, c.camera.height, c.camera.width),
                     dtype=torch.uint8)
    scene.render_uint8(torch.Generator(device=dev).manual_seed(GRAPH_SEED),
                       tr.ts[:GRAPH_FRAMES], tr.yaws[:GRAPH_FRAMES],
                       c.camera, tr.bg_slope, u8)
    images = reference.to_image(u8.to(dev))
    images[BLANK] = 0.0
    trk = program.tracker(c.config, c.camera.K(), dev)
    return trk.params, trk.K_inv, trk.focal, images


@pytest.fixture(scope="module")
def bench_scene():
    """The tsukuba.track cell's scene (``_cell_scene``)."""
    return _cell_scene("tsukuba.track")


def _init_graphs(step):
    """A copy of ``step.init_graphs``: each chain's captures."""
    return {k: dict(c) for k, c in step.init_graphs.items()}


class _SpanLog:
    """The names of the spans the step opens, one list a frame: a wrapper
    around ``vo_jit.span`` while in a ``with``."""

    def __init__(self):
        self.frames = []

    def __enter__(self):
        self._orig = orig = vo_jit.span

        def logged(name):
            if self.frames:
                self.frames[-1].append(name)
            return orig(name)

        vo_jit.span = logged
        return self

    def __exit__(self, *exc):
        vo_jit.span = self._orig


def _run_both(bench_scene, seed, frames=None, gates=()):
    """Both trackers over the scene (or its first ``frames``) from
    ``seed``, with the refined-error gate set to ``gates[t]`` on both sides
    before each frame ``t`` it names: per frame the entering mode, each
    side's (name, tensor) fields as returned, a copy of the graphed side's
    fields made right after its step, and the spans the graphed step
    opened; the graphed step's graphs after the first TRACKING frame,
    after the first bootstrap and at the end."""
    params, K_inv, focal, images = bench_scene
    dev = images.device
    graphed = vo_jit.make_vo_step(params)
    eager, _, _ = vo_jit._make_vo_step_fns(params, cuda_graphs=False)
    s_g = vo_init_state(params, device=dev, seed=seed)
    s_e = vo_init_state(params, device=dev, seed=seed)
    rec = dict(modes=[], graphed=[], eager=[], copies=[], first=None,
               init_first=None)
    with _SpanLog() as log:
        for t in range(images.shape[0] if frames is None else frames):
            if t in gates:
                s_g, s_e = (s._replace(gate_pair_err=torch.full_like(
                    s.gate_pair_err, gates[t])) for s in (s_g, s_e))
            rec["modes"].append(int(s_g.mode))
            log.frames.append([])
            s_g, o_g = graphed(s_g, images[t], K_inv, focal)
            s_e, o_e = eager(s_e, images[t], K_inv, focal)
            got = _fields(s_g, o_g)
            rec["graphed"].append(got)
            rec["copies"].append([(k, v.clone()) for k, v in got])
            rec["eager"].append(_fields(s_e, o_e))
            if rec["first"] is None and graphed.track_graphs:
                rec["first"] = dict(graphed.track_graphs)
            if (rec["init_first"] is None
                    and rec["modes"][-1] == vo_jit.MODE_INITIALIZING):
                rec["init_first"] = _init_graphs(graphed)
            if t == 0:
                rec["pre_first"] = dict(graphed.pre_graphs)
    rec["spans"] = log.frames
    rec["last"] = dict(graphed.track_graphs)
    rec["pre_last"] = dict(graphed.pre_graphs)
    rec["init_last"] = _init_graphs(graphed)
    assert not eager.track_graphs and not eager.pre_graphs
    assert not any(eager.init_graphs.values())
    return rec


@pytest.fixture(scope="module")
def graphed_and_eager(bench_scene):
    """``_run_both`` over the scene from tracker seed 7."""
    return _run_both(bench_scene, 7)


def _assert_graphed_equals_eager(rec):
    for t, (g, e) in enumerate(zip(rec["graphed"], rec["eager"])):
        for (name, a), (_, b) in zip(g, e):
            assert _same_bits(a, b), (t, name)


def _init_tried(rec, t):
    return int(dict(rec["graphed"][t])["out.init_tried"])


def _success(rec, t):
    return bool(dict(rec["graphed"][t])["out.success"])


def test_graphed_tracker_equals_eager_bitwise(graphed_and_eager):
    """Replaying the geometry stages and the bootstrap's chains gives the
    eager step's bits: every field of state and output on every frame,
    through bootstrap, TRACKING, the reset and the re-entry."""
    _assert_graphed_equals_eager(graphed_and_eager)


def test_every_bootstrap_frame_replays(graphed_and_eager):
    """Each frame that enters INITIALIZING opens ``vo_jit.init.graphed``
    around its slots and refine walk; the scene's bootstraps include one
    accepted and, right after the blank frame's reset, one where no slot
    passes and the window slides."""
    rec = graphed_and_eager
    init = [t for t, m in enumerate(rec["modes"])
            if m == vo_jit.MODE_INITIALIZING]
    assert init and BLANK + 1 in init
    for t, names in enumerate(rec["spans"]):
        want = t in init
        assert ("vo_jit.init.graphed" in names) == want, t
        if want:
            i = names.index("vo_jit.init.graphed")
            assert names[i + 1:i + 3] == ["vo_jit.init.slots",
                                          "vo_jit.init.refine"], t
    assert any(_success(rec, t) for t in init)
    assert not _success(rec, BLANK + 1)
    assert _init_tried(rec, BLANK + 1) == 0


def test_bootstrap_captures_once_and_replays_across_the_reset(
        graphed_and_eager):
    """One capture of each bootstrap chain, made on the first bootstrap
    frame, and replayed on every later one: after the reset and at the
    re-entry no chain captures again."""
    rec = graphed_and_eager
    first, last = rec["init_first"], rec["init_last"]
    assert set(first) == {"slots", "refine"}
    for chain in ("slots", "refine"):
        assert len(first[chain]) == 1, chain
        assert list(last[chain].items()) == list(first[chain].items())
    # the IRLS refits' eigh calls are the slot chain's eager stages
    (slots,) = first["slots"].values()
    eager = [g is None for g in slots.graphs]
    assert eager == [False] + [True, False] * 3


def test_state_from_a_bootstrap_survives_the_next_bootstrap(
        graphed_and_eager):
    """The pose a bootstrap seeds the state with, and its output, are the
    step's own: a later bootstrap's replays leave them as they were
    returned."""
    rec = graphed_and_eager
    init = [t for t, m in enumerate(rec["modes"])
            if m == vo_jit.MODE_INITIALIZING]
    accepted = [t for t in init if _success(rec, t)]
    assert len(accepted) >= 2 and accepted[0] < BLANK < accepted[-1]
    t = accepted[0]
    for (name, a), (_, b) in zip(rec["graphed"][t], rec["copies"][t]):
        if name == "state.generator":
            continue
        assert _same_bits(a, b), name
    # and none of them is a buffer of the chains' captures
    (slots,) = rec["init_last"]["slots"].values()
    (refine,) = rec["init_last"]["refine"].values()
    buffers = {x.data_ptr() for x in list(slots.v.cand)
               + list(refine.v.sel.values())}
    for k in (t, accepted[-1]):
        held = dict(rec["graphed"][k])
        for name in ("state.pose_R", "state.pose_t", "out.pose_R",
                     "out.pose_t", "out.num_inliers", "out.mean_error",
                     "out.pnp_t"):
            assert held[name].data_ptr() not in buffers, (k, name)


#: the refine walk's other cases on the scene, found on the card: from
#: tracker seed 0 under a refined-error gate of 1e-9 every bootstrap
#: refines its ranked slots and rejects them all (three on frame 3), and
#: at frame 4 a gate of 0.005 rejects the oldest slot (refined mean error
#: 0.0067) and accepts the next (0.0034)
WALK_SEED, WALK_GATES, WALK_FRAMES = 0, {0: 1e-9, 4: 5e-3}, 10


@pytest.fixture(scope="module")
def walk_run(bench_scene):
    return _run_both(bench_scene, WALK_SEED, WALK_FRAMES, WALK_GATES)


def test_refine_walk_replays_with_eager_bits(walk_run):
    """Bootstraps whose walk refines several slots and accepts none (the
    window slides), and one that falls back from the oldest slot to the
    next, replay the refine chain once a slot tried, with the eager
    step's bits on every frame."""
    rec = walk_run
    walks = [(t, _init_tried(rec, t), _success(rec, t))
             for t, m in enumerate(rec["modes"])
             if m == vo_jit.MODE_INITIALIZING]
    assert any(k >= 2 and not ok for _, k, ok in walks), walks
    assert (4, 2, True) in walks, walks
    for t, _, _ in walks:
        assert "vo_jit.init.graphed" in rec["spans"][t], t
    _assert_graphed_equals_eager(rec)


def test_reset_and_reentry_replay_without_a_new_capture(graphed_and_eager):
    modes = graphed_and_eager["modes"]
    tracking = [t for t, m in enumerate(modes) if m == vo_jit.MODE_TRACKING]
    # frames entering TRACKING before the blank frame, a reset after it,
    # and TRACKING again
    assert tracking and tracking[0] < BLANK and BLANK in tracking
    assert modes[BLANK + 1] == vo_jit.MODE_INITIALIZING
    assert any(t > BLANK + 1 for t in tracking)
    first, last = graphed_and_eager["first"], graphed_and_eager["last"]
    assert len(first) == 1
    assert list(last.items()) == list(first.items())   # the same graphs


def test_outputs_held_from_a_frame_survive_the_next(graphed_and_eager):
    """What a graphed step returned is its own: after every later frame ran
    it still holds the bits it had when it was returned."""
    rec = graphed_and_eager
    for t, (held, copy) in enumerate(zip(rec["graphed"], rec["copies"])):
        for (name, a), (_, b) in zip(held, copy):
            if name == "state.generator":
                continue        # the live generator's state, read anew
            assert _same_bits(a, b), (t, name)


def test_graphed_step_consumes_the_draws_it_is_given(bench_scene):
    """Draws given to a TRACKING frame go into the geometry chain's input
    buffer ``uniforms``, give the eager step's bits on the same draws, and
    leave the generator as it was."""
    params, K_inv, focal, images = bench_scene
    dev = images.device
    graphed = vo_jit.make_vo_step(params)
    eager, _, _ = vo_jit._make_vo_step_fns(params, cuda_graphs=False)
    s_g = vo_init_state(params, device=dev, seed=3)
    s_e = vo_init_state(params, device=dev, seed=3)
    gen = torch.Generator(device=dev).manual_seed(11)
    given = 0
    for t in range(12):
        draws = None
        if int(s_g.mode) == vo_jit.MODE_TRACKING:
            draws = torch.rand((params.pnp_hypotheses,
                                params.orb.max_features), generator=gen,
                               device=dev)
            before = s_g.generator.get_state()
        s_g, o_g = graphed(s_g, images[t], K_inv, focal, draws)
        s_e, o_e = eager(s_e, images[t], K_inv, focal, draws)
        for (name, a), (_, b) in zip(_fields(s_g, o_g), _fields(s_e, o_e)):
            assert _same_bits(a, b), (t, name)
        if draws is not None:
            given += 1
            (graphs,) = graphed.track_graphs.values()
            assert torch.equal(graphs.v.uniforms, draws)
            assert torch.equal(s_g.generator.get_state(), before)
    assert given >= 5


def test_graphed_bootstrap_consumes_the_draws_it_is_given(bench_scene):
    """Draws given to a bootstrap frame go into the slot chain's input
    buffer ``uniforms``, give the eager step's bits on the same draws, and
    leave the generator as it was."""
    params, K_inv, focal, images = bench_scene
    dev = images.device
    graphed = vo_jit.make_vo_step(params)
    eager, _, _ = vo_jit._make_vo_step_fns(params, cuda_graphs=False)
    s_g = vo_init_state(params, device=dev, seed=5)
    s_e = vo_init_state(params, device=dev, seed=5)
    gen = torch.Generator(device=dev).manual_seed(13)
    given = 0
    for t in list(range(4)) + list(range(BLANK - 1, BLANK + 4)):
        draws = None
        if int(s_g.mode) == vo_jit.MODE_INITIALIZING:
            draws = torch.rand((params.init_window, params.ransac_hypotheses,
                                params.orb.max_features), generator=gen,
                               device=dev)
            before = s_g.generator.get_state()
        s_g, o_g = graphed(s_g, images[t], K_inv, focal, draws)
        s_e, o_e = eager(s_e, images[t], K_inv, focal, draws)
        for (name, a), (_, b) in zip(_fields(s_g, o_g), _fields(s_e, o_e)):
            assert _same_bits(a, b), (t, name)
        if draws is not None:
            given += 1
            (slots,) = graphed.init_graphs["slots"].values()
            assert torch.equal(slots.v.uniforms, draws)
            assert torch.equal(s_g.generator.get_state(), before)
    assert given >= 2


def test_feature_half_captures_once_and_replays_across_the_reset(
        graphed_and_eager):
    """One capture of the feature half for the scene's image shape, made on
    the first frame and replayed on every later one, the blank frame's
    reset and the re-entry included; the geometry still one capture."""
    rec = graphed_and_eager
    assert len(rec["pre_first"]) == 1
    assert list(rec["pre_last"].items()) == list(rec["pre_first"].items())
    assert len(rec["last"]) == 1


def _pre_fields(out):
    f, smooth = out
    return [(f"frame.{k}", v) for k, v in f._asdict().items()] + [
        ("smooth", smooth)]


@pytest.fixture(scope="module")
def pre_halves(bench_scene):
    """The graphed and the op-by-op feature half over the scene, with the
    benchmark's ``K1Tap`` around K1 as the served loop installs it: per
    frame each side's (name, tensor) outputs, a copy of the graphed side's
    made right after its call, K1's launches during the graphed call, and
    the rank maps the tap kept from each side."""
    from slambench import program

    params, K_inv, focal, images = bench_scene
    _, g_pre, _ = vo_jit._make_vo_step_fns(params)
    _, e_pre, _ = vo_jit._make_vo_step_fns(params, cuda_graphs=False)
    rec = dict(graphed=[], eager=[], copies=[], launches=[], g_ranks=[],
               e_ranks=[])
    tap = program.K1Tap()
    tap.install()
    try:
        tap.want = True
        for t in range(images.shape[0]):
            before = features_cuda.fast_nms_harris_rank_pyramid.launches
            got = _pre_fields(g_pre(images[t], K_inv, focal))
            rec["launches"].append(
                features_cuda.fast_nms_harris_rank_pyramid.launches - before)
            rec["g_ranks"].append(tap.got)
            tap.got = None
            rec["graphed"].append(got)
            rec["copies"].append([(k, v.clone()) for k, v in got])
            rec["eager"].append(_pre_fields(e_pre(images[t], K_inv, focal)))
            rec["e_ranks"].append(tap.got)
            tap.got = None
    finally:
        tap.remove()
    rec["pre_graphs"] = dict(g_pre.pre_graphs)
    assert not e_pre.pre_graphs
    return rec


def test_graphed_feature_half_equals_eager_bitwise(pre_halves):
    """Every output of the replayed feature half (the frame's arrays and the
    smoothed image) has the op-by-op half's bits on every frame of the
    scene, the blank one included."""
    rec = pre_halves
    assert len(rec["graphed"]) == GRAPH_FRAMES and len(rec["pre_graphs"]) == 1
    for t, (g, e) in enumerate(zip(rec["graphed"], rec["eager"])):
        assert [k for k, _ in g] == [k for k, _ in e]
        for (name, a), (_, b) in zip(g, e):
            assert _same_bits(a, b), (t, name)


def test_k1_launches_once_a_frame_and_the_tap_sees_each(pre_halves):
    """K1 stays an eager launch under replay: its counter rises by one a
    frame, and a wrapper put on ``features_cuda`` (the benchmark's
    ``K1Tap``) gets a fresh rank map every frame, with the op-by-op half's
    bits."""
    rec = pre_halves
    assert rec["launches"] == [1] * GRAPH_FRAMES
    ptrs = set()
    for t, (g, e) in enumerate(zip(rec["g_ranks"], rec["e_ranks"])):
        assert g is not None and len(g) == P.num_levels, t
        ptrs.add(g[0].data_ptr())
        for a, b in zip(g, e):
            assert _same_bits(a, b), t
    assert len(ptrs) == GRAPH_FRAMES


def test_features_held_from_a_frame_survive_the_next(pre_halves):
    """What the graphed feature half returned is its own: after every later
    frame ran it still holds the bits it had when it was returned."""
    rec = pre_halves
    for t, (held, copy) in enumerate(zip(rec["graphed"], rec["copies"])):
        for (name, a), (_, b) in zip(held, copy):
            assert _same_bits(a, b), (t, name)


def test_another_image_size_gets_its_own_feature_capture(bench_scene):
    """A 240x320 image beside the cell's 288x384 ones: one capture each,
    each replayed with the op-by-op half's bits; a focal given as a number
    keys its own."""
    params, K_inv, focal, images = bench_scene
    _, g_pre, _ = vo_jit._make_vo_step_fns(params)
    _, e_pre, _ = vo_jit._make_vo_step_fns(params, cuda_graphs=False)
    small = torch.nn.functional.interpolate(
        images[:2, None], size=(240, 320), mode="bilinear",
        align_corners=False)[:, 0].contiguous()
    for img in (images[0], small[0], images[1], small[1]):
        for f in (focal, float(focal)):
            got, want = g_pre(img, K_inv, f), e_pre(img, K_inv, f)
            for (name, a), (_, b) in zip(_pre_fields(got),
                                         _pre_fields(want)):
                assert _same_bits(a, b), (tuple(img.shape), name)
    assert len(g_pre.pre_graphs) == 4
    shapes = {key[0][1][0][2] for key in g_pre.pre_graphs}
    assert shapes == {(288, 384), (240, 320)}


@pytest.mark.parametrize("batched,subpixel", [(True, False), (False, True),
                                              (True, True)])
def test_both_orb_layouts_capture(bench_scene, batched, subpixel):
    """The ORB options' feature half captures too (the batched layout's
    one flat rank buffer, the subpixel fit's float64 Harris surface) and
    replays with the op-by-op bits, K1 still one launch a frame."""
    params, K_inv, focal, images = bench_scene
    params = params._replace(orb=params.orb._replace(batched=batched,
                                                     subpixel=subpixel))
    _, g_pre, _ = vo_jit._make_vo_step_fns(params)
    _, e_pre, _ = vo_jit._make_vo_step_fns(params, cuda_graphs=False)
    for t in range(4):
        before = features_cuda.fast_nms_harris_rank_pyramid.launches
        got = _pre_fields(g_pre(images[t], K_inv, focal))
        assert features_cuda.fast_nms_harris_rank_pyramid.launches == \
            before + 1
        for (name, a), (_, b) in zip(got, _pre_fields(
                e_pre(images[t], K_inv, focal))):
            assert _same_bits(a, b), (t, name)
    assert len(g_pre.pre_graphs) == 1


# -- the KITTI deployment's sizes ---------------------------------------------

@pytest.fixture(scope="module")
def kitti_run():
    """``_run_both`` over the kitti.track cell's scene from tracker seed 7:
    2,000 features a frame, 4,096 map slots, the BA over 1,536 + 512
    points with the Huber kernel on."""
    scene = _cell_scene("kitti.track")
    return scene[0], _run_both(scene, 7)


def test_kitti_graphed_tracker_equals_eager_bitwise(kitti_run):
    """At the KITTI sizes with Huber on, the three chains replay with the
    op-by-op step's bits on every field of every frame: bootstrap frames,
    accepted TRACKING frames, the blank frame's reset and the re-entry."""
    params, rec = kitti_run
    assert params.orb.max_features == 2000 and params.map_capacity == 4096
    assert (params.ba_old, params.ba_new) == (1536, 512)
    assert params.huber_delta == pytest.approx(2.4477)
    modes = rec["modes"]
    tracking = [t for t, m in enumerate(modes) if m == vo_jit.MODE_TRACKING]
    init = [t for t, m in enumerate(modes)
            if m == vo_jit.MODE_INITIALIZING]
    assert init and BLANK + 1 in init and any(t > BLANK + 1 for t in tracking)
    assert sum(_success(rec, t) for t in tracking) >= 10
    assert any(_success(rec, t) for t in init)
    assert modes[BLANK + 1] == vo_jit.MODE_INITIALIZING
    _assert_graphed_equals_eager(rec)
    for chain in ("slots", "refine"):
        assert len(rec["init_last"][chain]) == 1, chain
    assert len(rec["last"]) == 1 and len(rec["pre_last"]) == 1


def test_kitti_counters_on_the_device():
    """The counter pass of the traced run (``slambench/counters.py``, the
    op-by-op step with the BA tapped) on the card at the KITTI sizes: the
    profiled TRACKING frames' keypoints at the budget (every level of the
    pyramid has more corners than its share), the BA's robust share a
    share that the Huber kernel makes non-zero on some frame, and the tap
    taken off after the pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from slambench import cell as bench_cell
    from slambench import counters, scene, serve

    dev = torch.device("cuda", 0)
    c = bench_cell.resolve("kitti.track")
    tr = c.traffic
    n = tr.profile_start + serve.PROFILE_CAP * tr.profile_frames
    u8 = torch.empty((n, c.camera.height, c.camera.width), dtype=torch.uint8)
    scene.render_uint8(torch.Generator(device=dev).manual_seed(GRAPH_SEED),
                       tr.ts[:n], tr.yaws[:n], c.camera, tr.bg_slope, u8)
    ba = vo_jit.ba_mod
    got = counters.counter_pass(c, u8, dev)
    assert vo_jit.ba_mod is ba
    kp, robust = got["n_keypoints"], got["ba_robust"]
    assert len(kp) == len(robust) == tr.profile_frames
    assert min(kp) >= 1900 and max(kp) <= 2000
    assert all(0.0 <= r <= 1.0 for r in robust) and max(robust) > 0.0

