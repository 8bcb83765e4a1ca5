"""The PyTorch port's SLAM back-end against the JAX package's, as a whole.

The JAX tracker runs once over the 90-frame closed ellipse of
``tests/test_loop_closure.py`` (240x320, focal 280, slanted background).
Every frame's ``(state, out)`` goes to the JAX back-end and, through
``mvslam_tpu_torch.convert``, to the port's, which also gets the RANSAC
uniforms the JAX back-end will draw from its key. Compared: keyframes, loop
edges (pairs, inliers, scale ratios, poses), the loop kernels on one stored
keyframe pair, both graph optimizations on the same skeleton, and the
corrected trajectory. Port only: the loop-closure bars of the JAX test, the
two-segment ``correct_trajectory``, the full-store warning, ``mesh``.
"""

import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.backend import slam as jslam
from mvslam_tpu.frontend import vo_jit as jv
from mvslam_tpu.math.lie import SE3 as JSE3
from mvslam_tpu_torch import convert
from mvslam_tpu_torch.backend import slam as tslam
from mvslam_tpu_torch.frontend import vo_jit as tv
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops.features import OrbParams
from mvslam_tpu_torch.utils.scene import ellipse_loop, render_planes_sequence

H, W, FOCAL = 240, 320, 280.0
#: loop-edge poses, relative to the edge's length (1 to 4.5 tracker units)
#: or 1, whichever is larger: a float32 P3P resection and a 15-iteration
#: two-frame BA polish on both sides, summed in different orders (measured
#: worst 1.1e-3 absolute on a 4.5-unit edge)
EDGE_ATOL = 1e-3
#: float64 graphs on the same skeleton, and the trajectory corrected by them
GRAPH_ATOL = 1e-4


def jax_loop_uniforms(key, hypotheses, K):
    """What the JAX back-end draws from ``key`` for its (up to) two loop
    candidates: per candidate one three-way split, then (forward, backward)
    uniforms as ``ransac.sample_minimal_sets`` draws them."""
    out = []
    for _ in range(2):
        key, k1, k2 = jax.random.split(key, 3)
        out.append([np.asarray(jax.random.uniform(k, (hypotheses, K)))
                    for k in (k1, k2)])
    return torch.tensor(np.asarray(out))


@pytest.fixture(scope="module")
def loop():
    ts_gt = ellipse_loop()
    frames = render_planes_sequence(ts_gt, h=H, w=W, focal=FOCAL,
                                    bg_slope=0.18)
    params = jv.VoJitParams()
    step = jv.make_vo_step(params)
    K_inv = jnp.asarray(np.linalg.inv(np.asarray(
        [[FOCAL, 0, (W - 1) / 2], [0, FOCAL, (H - 1) / 2], [0, 0, 1]],
        np.float64)), jnp.float32)
    focal = jnp.asarray(FOCAL, jnp.float32)
    jb = jslam.PoseGraphBackend(jslam.BackendParams(), focal=FOCAL)
    tb = tslam.PoseGraphBackend(tslam.BackendParams(), focal=FOCAL,
                                device="cpu")
    state = jv.vo_init_state(params)
    raw, ok, accepted = [], [], []
    for i in range(frames.shape[0]):
        state, out = step(state, jnp.asarray(frames[i]), K_inv, focal)
        uniforms = jax_loop_uniforms(jb._key, jb.p.loop_hypotheses,
                                     params.orb.max_features)
        j_acc = jb.add_frame(i, state, out)
        tstate = convert.state_from_numpy(
            {k: np.asarray(v) for k, v in state._asdict().items()
             if k != "key"}, device="cpu")
        tout = convert.step_out_from_numpy(
            {k: np.asarray(v) for k, v in out._asdict().items()},
            device="cpu")
        t_acc = tb.add_frame(i, tstate, tout, uniforms=uniforms)
        accepted.append((j_acc, t_acc))
        ok.append(bool(out.success))
        raw.append(np.asarray(out.pose_t))
    return dict(ts_gt=ts_gt, raw=np.asarray(raw), ok=np.asarray(ok), jb=jb,
                tb=tb, accepted=accepted)


def test_same_keyframes(loop):
    jb, tb = loop["jb"], loop["tb"]
    assert len(tb.keyframes) >= 10
    assert [k.frame_idx for k in tb.keyframes] == [
        k.frame_idx for k in jb.keyframes]
    assert [k.segment for k in tb.keyframes] == [
        k.segment for k in jb.keyframes]
    for tk, jk in zip(tb.keyframes, jb.keyframes):
        assert tk.num_inliers == jk.num_inliers
        assert tk.mean_error == pytest.approx(jk.mean_error, rel=1e-6)
        np.testing.assert_array_equal(tk.pose.t.numpy(),
                                      np.asarray(jk.pose.t, np.float64))
        assert tk.pose.t.dtype == torch.float64 and not tk.pose.t.is_cuda


def test_same_keyframe_stores(loop):
    jb, tb = loop["jb"], loop["tb"]
    n = len(jb.keyframes)
    assert tb._desc.shape[0] == tb.p.max_keyframes       # preallocated
    for name in tslam._STORES:
        got = getattr(tb, name)[:n].numpy()
        want = getattr(jb, name)
        if name == "_desc":
            got = got.view(np.uint32)
        if name in ("_lm", "_lm_info"):
            # kf-local landmarks and their rotated information: float32
            # products on both sides
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert float(tb._lm[n:].abs().max()) == 0.0


def test_same_loop_edges(loop):
    jb, tb = loop["jb"], loop["tb"]
    assert jb.loop_edges, "the JAX back-end accepted no loop closure"
    assert [(e[0], e[1]) for e in tb.loop_edges] == [
        (e[0], e[1]) for e in jb.loop_edges]
    assert all(a == b for a, b in loop["accepted"])
    for te, je in zip(tb.loop_edges, jb.loop_edges):
        assert abs(te[3] - je[3]) <= 2, (te[:2], te[3], je[3])
        assert te[4] == pytest.approx(je[4], abs=1e-3)
        assert 0.8 < te[4] < 1.25
        span = max(float(np.linalg.norm(np.asarray(je[2].t))), 1.0)
        np.testing.assert_allclose(te[2].t.numpy(), np.asarray(je[2].t),
                                   rtol=0, atol=EDGE_ATOL * span)
        np.testing.assert_allclose(te[2].R.numpy(), np.asarray(je[2].R),
                                   rtol=0, atol=EDGE_ATOL)
    assert [d["use_ba"] for d in tb.loop_debug] == [
        d["use_ba"] for d in jb.loop_debug]


def test_loop_match_counts_match(loop):
    jb, tb = loop["jb"], loop["tb"]
    n = len(jb.keyframes)
    i = n - 1
    want = np.asarray(jslam._loop_match_counts(
        jnp.asarray(jb._desc[i]), jnp.asarray(jb._mask[i]),
        jnp.asarray(jb._desc), jnp.asarray(jb._mask), 64))
    got = tslam._loop_match_counts(tb._desc[i], tb._mask[i], tb._desc[:n],
                                   tb._mask[:n], 64)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[i] == jb._mask[i].sum() and want.max() == want[i]


def test_loop_rel_pose_and_refine_ba_match(loop):
    """Both loop kernels on the first accepted pair's stored rows, the
    port fed the uniforms of the JAX call's key."""
    jb, tb = loop["jb"], loop["tb"]
    j, i = jb.loop_edges[0][:2]
    thr_sq = (jb.p.loop_reproj_px / FOCAL) ** 2
    key = jax.random.PRNGKey(42)
    J = jnp.asarray
    jR, jt, jn = jslam._loop_rel_pose(
        J(jb._desc[i]), J(jb._mask[i]), J(jb._rays[i]), J(jb._desc[j]),
        J(jb._mask[j]), J(jb._lm[j]), J(jb._lm_mask[j]), key,
        jnp.asarray(thr_sq, jnp.float32), 128, 64)
    uniforms = torch.tensor(np.asarray(jax.random.uniform(key, (128, 512))))
    tR, tt, tn = tslam._loop_rel_pose(
        tb._desc[i], tb._mask[i], tb._rays[i], tb._desc[j], tb._mask[j],
        tb._lm[j], tb._lm_mask[j], thr_sq, 128, 64, uniforms=uniforms)
    assert int(jn) >= jb.p.min_loop_inliers
    assert abs(int(tn) - int(jn)) <= 2
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), rtol=0, atol=1e-5)

    jres = jslam._loop_refine_ba(
        J(jb._desc[j]), J(jb._mask[j]), J(jb._rays[j]), J(jb._sigma[j]),
        J(jb._lm[j]), J(jb._lm_mask[j]), J(jb._desc[i]), J(jb._mask[i]),
        J(jb._rays[i]), J(jb._sigma[i]), jR, jt,
        jnp.asarray(thr_sq, jnp.float32), jnp.asarray(0.05, jnp.float32), 64)
    tres = tslam._loop_refine_ba(
        tb._desc[j], tb._mask[j], tb._rays[j], tb._sigma[j], tb._lm[j],
        tb._lm_mask[j], tb._desc[i], tb._mask[i], tb._rays[i], tb._sigma[i],
        torch.tensor(np.asarray(jR)), torch.tensor(np.asarray(jt)), thr_sq,
        0.05, 64)
    assert int(tres[2]) == int(jres[2]) > 0
    np.testing.assert_allclose(tres[1].numpy(), np.asarray(jres[1]), rtol=0,
                               atol=EDGE_ATOL)
    np.testing.assert_allclose(tres[0].numpy(), np.asarray(jres[0]), rtol=0,
                               atol=EDGE_ATOL)
    assert float(tres[3]) == pytest.approx(float(jres[3]), rel=1e-2)


def test_generator_path_draws_on_the_backends_device(loop):
    """Without ``uniforms`` the draws come from the back-end's generator."""
    tb = loop["tb"]
    j, i = tb.loop_edges[0][:2]
    thr_sq = (tb.p.loop_reproj_px / FOCAL) ** 2
    args = (tb._desc[i], tb._mask[i], tb._rays[i], tb._desc[j], tb._mask[j],
            tb._lm[j], tb._lm_mask[j], thr_sq, 128, 64)
    g = torch.Generator(device="cpu").manual_seed(1)
    a = tslam._loop_rel_pose(*args, generator=g)
    b = tslam._loop_rel_pose(
        *args, generator=torch.Generator(device="cpu").manual_seed(1))
    assert torch.equal(a[1], b[1]) and int(a[2]) >= tb.p.min_loop_inliers
    assert tb._generator.device.type == "cpu"


@pytest.fixture(scope="module")
def same_skeleton(loop):
    """The JAX back-end's skeleton loaded into a port back-end."""
    return convert.backend_from_numpy(
        convert.backend_to_numpy(loop["jb"]), tslam.BackendParams(),
        focal=FOCAL, device="cpu")


def test_backend_state_round_trips(loop, same_skeleton):
    d = convert.backend_to_numpy(loop["jb"])
    back = convert.backend_to_numpy(same_skeleton)
    assert d.keys() == back.keys()
    for k in d:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)


@pytest.mark.parametrize("method", ["sim3", "se3"])
def test_optimize_and_correct_match_on_the_same_skeleton(loop, same_skeleton,
                                                         method):
    jb = loop["jb"]
    want = jb.optimize(method=method)
    got = same_skeleton.optimize(method=method)
    assert got.t.dtype == torch.float64
    # the back-end keeps the solver's result of its last optimize()
    last = same_skeleton.last_result
    assert bool(last.converged) and 0 < int(last.iterations) < 100
    n = len(same_skeleton.keyframes)
    assert torch.equal(last.poses.t[:n], got.t)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0,
                               atol=GRAPH_ATOL)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0,
                               atol=GRAPH_ATOL)
    j_corr = jb.correct_trajectory(want)
    t_corr = same_skeleton.correct_trajectory(got)
    assert [c[0] for c in t_corr] == [c[0] for c in j_corr]
    for (_, tR, tt), (_, jR, jt) in zip(t_corr, j_corr):
        np.testing.assert_allclose(tt, jt, rtol=0, atol=GRAPH_ATOL)
        np.testing.assert_allclose(tR, jR, rtol=0, atol=GRAPH_ATOL)


def test_graph_data_is_float64_and_unpadded(loop):
    tb = loop["tb"]
    n = len(tb.keyframes)
    e = n - 1 + len(tb.loop_edges)
    data = tb._build_sim3_data()
    assert data.poses.t.dtype == data.edge_info.dtype == torch.float64
    assert data.poses.t.shape == (n, 3) and data.edge_src.shape == (e,)
    assert bool(data.node_mask.all()) and bool(data.edge_mask.all())
    g, ids = tb.build_graph()
    assert g.node_count() == n and g.edge_count() == e and ids == list(range(n))
    assert g.to_data().poses.t.dtype == torch.float64


def _fit_scale(raw, gt, n):
    half = np.arange(2, n // 2)
    X, G = raw[half], gt[half]
    Xc, Gc = X - X.mean(0), G - G.mean(0)
    return float((Xc * Gc).sum() / max((Xc * Xc).sum(), 1e-12))


def test_port_backend_closes_the_loop(loop):
    """The bars of ``tests/test_loop_closure.py`` on the port's own
    skeleton: tracked throughout, one segment, optimized closure error at
    most a quarter of the raw one and at most 0.08."""
    ts_gt, raw, ok, tb = loop["ts_gt"], loop["raw"], loop["ok"], loop["tb"]
    n = len(raw)
    assert ok[1:].all()
    assert all(k.segment == 0 for k in tb.keyframes)
    gt = ts_gt - ts_gt[0]
    s = _fit_scale(raw, gt, n)
    kf0 = tb.keyframes[0]
    d_gt_end = gt[-1] - gt[kf0.frame_idx]

    def closure(t_end, t_anchor):
        return float(np.linalg.norm(
            s * (np.asarray(t_end) - np.asarray(t_anchor)) - d_gt_end))

    raw_cl = closure(raw[-1], kf0.pose.t.numpy())
    assert raw_cl > 0.05
    opt = tb.optimize(method="sim3")
    corrected = tb.correct_trajectory(opt)
    idx_last, _, t_last = corrected[-1]
    assert idx_last == n - 1 and len(corrected) == len(tb.raw_poses())
    opt_cl = closure(t_last, opt.t[0].numpy())
    assert opt_cl <= raw_cl / 4.0, (raw_cl, opt_cl)
    assert opt_cl <= 0.08, opt_cl


def test_windowed_refine_matches(loop, same_skeleton):
    idxs, poses, err = same_skeleton.windowed_refine(window=4)
    j_idxs, j_poses, j_err = loop["jb"].windowed_refine(window=4)
    assert idxs == j_idxs
    # a float32 4-frame BA under weak regulator priors, 20 iterations:
    # 1e-3 of the window's distance from the origin (13 units)
    scale = float(np.abs(np.asarray(j_poses.t)).max())
    np.testing.assert_allclose(poses.t.numpy(), np.asarray(j_poses.t),
                               rtol=0, atol=1e-3 * scale)
    assert err == pytest.approx(j_err, rel=1e-2)


# ---------------------------------------------------------------------------
# port only: small fabricated feeds
# ---------------------------------------------------------------------------


def _tiny_state():
    params = tv.VoJitParams(map_capacity=16, init_window=2,
                            orb=OrbParams(max_features=8))
    return tv.vo_init_state(params, device="cpu")


def _out(success: bool, t) -> tv.VoStepOut:
    return tv.VoStepOut(
        success=torch.tensor(success), mode=torch.tensor(2, dtype=torch.int32),
        pose_R=torch.eye(3), pose_t=torch.tensor(t, dtype=torch.float32),
        num_inliers=torch.tensor(50, dtype=torch.int32),
        mean_error=torch.tensor(1.0), pnp_t=torch.zeros(3),
        init_tried=torch.tensor(0, dtype=torch.int32))


def _two_segment_backend():
    """Frames 0-7 tracked, 8 lost, 9-16 tracked from a fresh origin;
    a keyframe every second tracked frame."""
    tb = tslam.PoseGraphBackend(tslam.BackendParams(keyframe_every=2),
                                device="cpu")
    state = _tiny_state()
    for i in range(17):
        if i < 8:
            tb.add_frame(i, state, _out(True, [0.1 * i, 0.0, 0.0]))
        elif i == 8:
            tb.add_frame(i, state, _out(False, [0.0, 0.0, 0.0]))
        else:
            tb.add_frame(i, state, _out(True, [0.05 * (i - 9), 0.0, 0.0]))
    return tb


def test_segments_of_a_two_segment_feed():
    tb = _two_segment_backend()
    assert [k.frame_idx for k in tb.keyframes] == [0, 2, 4, 6, 10, 12, 14, 16]
    assert [k.segment for k in tb.keyframes] == [0, 0, 0, 0, 1, 1, 1, 1]
    assert [r[0] for r in tb._raw_poses] == [*range(8), *range(9, 17)]
    assert [r[1] for r in tb._raw_poses] == [0] * 8 + [1] * 8
    # no odometry edge across the break; the new segment is anchored
    edges, anchors = tb._edges()
    assert [(e[0], e[1]) for e in edges] == [(0, 1), (1, 2), (2, 3), (4, 5),
                                             (5, 6), (6, 7)]
    assert anchors == [0, 4]
    for method in ("sim3", "se3"):
        opt = tb.optimize(method=method)
        np.testing.assert_allclose(
            opt.t.numpy(), np.stack([k.pose.t.numpy() for k in tb.keyframes]),
            atol=1e-6)


def test_correct_trajectory_stays_within_a_segment():
    """A frame tracked after a reset, before its segment's first keyframe,
    passes through unchanged; the JAX package corrects it by the segment
    before (its known fault). Every other frame agrees with the JAX
    package."""
    tb = _two_segment_backend()
    shift = np.array([[0.0, 1.0, 0.0]] * 4 + [[0.0, 0.0, -2.0]] * 4)
    kf_t = np.stack([k.pose.t.numpy() for k in tb.keyframes])
    opt = SE3(torch.eye(3, dtype=torch.float64).expand(8, 3, 3),
              torch.tensor(kf_t + shift))
    corrected = tb.correct_trajectory(opt)
    raw = tb.raw_poses()
    assert [c[0] for c in corrected] == [r[0] for r in raw]
    by_frame = {c[0]: c[2] for c in corrected}
    raw_by_frame = {r[0]: r[2] for r in raw}
    for i in range(8):
        np.testing.assert_allclose(by_frame[i], raw_by_frame[i] + shift[0],
                                   atol=1e-12)
    np.testing.assert_array_equal(by_frame[9], raw_by_frame[9])
    for i in range(10, 17):
        np.testing.assert_allclose(by_frame[i], raw_by_frame[i] + shift[4],
                                   atol=1e-12)

    jb = jslam.PoseGraphBackend(jslam.BackendParams(keyframe_every=2))
    jb.keyframes = [
        jslam.Keyframe(k.frame_idx, JSE3(jnp.asarray(k.pose.R.numpy()),
                                         jnp.asarray(k.pose.t.numpy())),
                       k.num_inliers, k.mean_error, k.segment)
        for k in tb.keyframes]
    jb._raw_poses = [(i, R, t) for i, R, t in raw]
    j_corr = {c[0]: c[2] for c in jb.correct_trajectory(
        JSE3(jnp.asarray(opt.R.numpy()), jnp.asarray(opt.t.numpy())))}
    for i in by_frame:
        if i == 9:
            np.testing.assert_allclose(j_corr[9], raw_by_frame[9] + shift[0],
                                       atol=1e-12)
        else:
            np.testing.assert_allclose(by_frame[i], j_corr[i], atol=1e-12)


def test_full_keyframe_store_warns_once():
    tb = tslam.PoseGraphBackend(
        tslam.BackendParams(keyframe_every=1, max_keyframes=3), device="cpu")
    state = _tiny_state()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(6):
            tb.add_frame(i, state, _out(True, [0.1 * i, 0.0, 0.0]))
    assert len(tb.keyframes) == 3 and tb._desc.shape[0] == 3
    assert len(caught) == 1 and "keyframe store is full" in str(
        caught[0].message)
    assert len(tb.raw_poses()) == 6            # frames are still recorded


def test_optimize_with_a_mesh_is_refused():
    """``optimize(mesh=...)`` shards the edges over a ``DeviceMesh``
    (``test_torch_parallel.py`` runs it on one and four ranks); what is no
    mesh is refused, for both graphs."""
    tb = _two_segment_backend()
    with pytest.raises(TypeError, match="DeviceMesh"):
        tb.optimize(mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tb.optimize(mesh=object(), method="se3")


def test_backend_defaults_to_the_card():
    sig = inspect.signature(tslam.PoseGraphBackend.__init__).parameters
    assert sig["device"].default == "cuda"
    assert inspect.signature(
        convert.backend_from_numpy).parameters["device"].default == "cuda"
