"""Checkpoints of the port: its own round trip gives bit-equal next-frame
poses; a file written by the JAX package loads into the port and the other
way, in both states of the odometer, under the same field names and
dtypes; a capacity mismatch raises ``ValueError``. CPU, float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.frontend import visual_odometer as jvo
from mvslam_tpu.frontend import vo_jit as jvj
from mvslam_tpu.frontend.frame_manager import FrameManager as JFrameManager
from mvslam_tpu.io import checkpoint as jck
from mvslam_tpu.ops import features as jfeat
from mvslam_tpu.ops.camera import PinholeCamera as JCamera
from mvslam_tpu_torch import convert
from mvslam_tpu_torch.frontend import visual_odometer as tvo
from mvslam_tpu_torch.frontend import vo_jit as tvj
from mvslam_tpu_torch.io import checkpoint as tck
from mvslam_tpu_torch.ops import features as tfeat
from mvslam_tpu_torch.utils.scene import render_planes_sequence

H, W, FOCAL = 240, 320, 280.0
N_FRAMES = 6
#: in this run frame 1 bootstraps, frame 2 fails the error gate (back to
#: INITIALIZING), frame 3 bootstraps again, frames 4 and 5 are tracked
AFTER = {"TRACKING": 5, "INITIALIZING": 3}      # frames fed before saving


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The odometer on the CPU is thousands of tiny ops per frame: with the
    suite's workers side by side, torch's intra-op pool only makes them
    fight for the cores (measured: this file 4-40x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uniforms(seed, n=512):
    return torch.tensor(np.asarray(
        jax.random.uniform(jax.random.PRNGKey(seed), (256, n))))


@pytest.fixture(scope="module")
def frames():
    """The JAX package's frames and the same frames carried into the
    port."""
    # the renderer sizes its textures by the whole path: render the ten
    # frames of the front-end tests' scene, then cut
    i = np.arange(10)
    ts = np.stack([i * 0.12, 0.02 * np.sin(i * 0.25), np.zeros(10)], 1)
    images = render_planes_sequence(ts, h=H, w=W, focal=FOCAL,
                                    bg_slope=0.18)[:N_FRAMES]
    jfm = JFrameManager(camera=JCamera.from_params(
        FOCAL, FOCAL, 0.0, (W - 1) / 2, (H - 1) / 2, dtype=jnp.float32))
    jf = [jfm.add_frame(0.1 * (k + 1), jnp.asarray(img, jnp.float32))
          for k, img in enumerate(images)]
    return jf, [convert.frame_from_numpy(convert.frame_to_numpy(f), "cpu")
                for f in jf]


def _run_port(tf, n):
    tv = tvo.VisualOdometer(device="cpu")
    for k in range(n):
        tv.add_frame(tf[k], uniforms=_uniforms(k + 1))
    return tv


def _run_jax(jf, n):
    jv = jvo.VisualOdometer()
    for k in range(n):
        jv.add_frame(jf[k])
    return jv


@pytest.fixture(scope="module")
def saved(frames, tmp_path_factory):
    """Per state: both odometers fed up to the save point, and each
    package's file of its own odometer."""
    jf, tf = frames
    d = tmp_path_factory.mktemp("ckpt")
    out = {}
    for state, n in AFTER.items():
        jv, tv = _run_jax(jf, n), _run_port(tf, n)
        assert jv.state.name == tv.state.name == state
        jpath, tpath = str(d / f"j_{state}.npz"), str(d / f"t_{state}.npz")
        jck.save_checkpoint(jv, jpath)
        tck.save_checkpoint(tv, tpath)
        out[state] = (jv, tv, jpath, tpath, n)
    return out


def _same_state(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("state", list(AFTER))
def test_files_carry_the_same_fields_and_dtypes(saved, state):
    _, _, jpath, tpath, _ = saved[state]
    jz, tz = np.load(jpath), np.load(tpath)
    assert sorted(jz.files) == sorted(tz.files)
    for k in jz.files:
        assert tz[k].dtype == jz[k].dtype, k
        assert tz[k].shape == jz[k].shape, k
    assert tz["map_desc"].dtype == np.uint32
    assert tck.SCHEMA_VERSION == jck.SCHEMA_VERSION
    assert tck.JIT_SCHEMA_VERSION == jck.JIT_SCHEMA_VERSION


@pytest.mark.parametrize("state", list(AFTER))
def test_round_trip_restores_the_state_bit_for_bit(saved, state):
    _, tv, _, tpath, _ = saved[state]
    back = tck.load_checkpoint(tpath, tvo.VisualOdometer(device="cpu"))
    _same_state(convert.odometer_to_numpy(back),
                convert.odometer_to_numpy(tv, window=False) | {"window": []})
    assert back.trajectory and len(back.trajectory) == tv.frame_tracked
    assert back.state == tv.state and back._step == tv._step


def _resumed_and_live(tv, tpath):
    back = tck.load_checkpoint(tpath, tvo.VisualOdometer(device="cpu"))
    live = convert.odometer_from_numpy(convert.odometer_to_numpy(tv),
                                       tvo.VisualOdometer(device="cpu"))
    return back, live


def test_round_trip_gives_bit_equal_next_poses(frames, saved):
    """The resumed odometer and one that never went through a file track
    the next frame to the same bits: under the same uniforms, and when
    each draws from its own generator seeded by the step count (whose
    draws here end at the error gate: the same number on both)."""
    _, tf = frames
    _, tv, _, tpath, n = saved["TRACKING"]
    back, live = _resumed_and_live(tv, tpath)
    a = live.add_frame(tf[n], uniforms=_uniforms(n + 1))
    b = back.add_frame(tf[n], uniforms=_uniforms(n + 1))
    assert a.success and a.reason == b.reason == "tracked"
    assert a.num_inliers == b.num_inliers and a.mean_error == b.mean_error
    assert torch.equal(a.pose.t, b.pose.t) and torch.equal(a.pose.R, b.pose.R)
    assert torch.equal(live._map.positions, back._map.positions)
    assert torch.equal(live._last_obs_rays, back._last_obs_rays)
    back, live = _resumed_and_live(tv, tpath)
    a, b = live.add_frame(tf[n]), back.add_frame(tf[n])
    assert a[2:] == b[2:] and a.num_inliers > 100
    assert np.isfinite(a.mean_error)


@pytest.mark.parametrize("state", list(AFTER))
def test_jax_file_loads_into_the_port(frames, saved, state):
    """The port resumed from the JAX package's file continues as the JAX
    odometer does (``t`` within 1e-3 at 3 baselines travelled: one
    float32 LM on the same inputs)."""
    jf, tf = frames
    jv, _, jpath, _, n = saved[state]
    tv = tck.load_checkpoint(jpath, tvo.VisualOdometer(device="cpu"))
    _same_state(convert.odometer_to_numpy(tv, window=False),
                convert.odometer_to_numpy(jv, window=False))
    live = jck.load_checkpoint(jpath, jvo.VisualOdometer())
    want = live.add_frame(jf[n])
    got = tv.add_frame(tf[n], uniforms=_uniforms(live._step))
    assert (got.success, got.reason, got.num_inliers) == (
        want.success, want.reason, want.num_inliers)
    if want.success:
        np.testing.assert_allclose(got.pose.t.numpy(), np.asarray(want.pose.t),
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("state", list(AFTER))
def test_port_file_loads_into_the_jax_package(frames, saved, state):
    jf, tf = frames
    _, tv, _, tpath, n = saved[state]
    jv = jck.load_checkpoint(tpath, jvo.VisualOdometer())
    _same_state(convert.odometer_to_numpy(jv, window=False),
                convert.odometer_to_numpy(tv, window=False))
    want = jv.add_frame(jf[n])
    back = tck.load_checkpoint(tpath, tvo.VisualOdometer(device="cpu"))
    got = back.add_frame(tf[n], uniforms=_uniforms(jv._step))
    assert (got.success, got.reason, got.num_inliers) == (
        want.success, want.reason, want.num_inliers)
    if want.success:
        np.testing.assert_allclose(got.pose.t.numpy(), np.asarray(want.pose.t),
                                   rtol=0, atol=1e-3)


def test_capacity_mismatch_raises(saved):
    _, _, jpath, tpath, _ = saved["TRACKING"]
    small = tvo.VoParams(max_map_points=256)
    for path in (jpath, tpath):
        with pytest.raises(ValueError, match="capacity"):
            tck.load_checkpoint(path, tvo.VisualOdometer(small, device="cpu"))


def test_unknown_schema_raises(saved, tmp_path):
    _, _, _, tpath, _ = saved["INITIALIZING"]
    z = dict(np.load(tpath))
    z["meta"] = np.asarray(str(z["meta"]).replace('"schema": 1',
                                                  '"schema": 99'))
    np.savez_compressed(str(tmp_path / "bad.npz"), **z)
    with pytest.raises(ValueError, match="schema"):
        tck.load_checkpoint(str(tmp_path / "bad.npz"),
                            tvo.VisualOdometer(device="cpu"))


# -- the fused tracker's state ----------------------------------------------


def _jit_params():
    return (tvj.VoJitParams(map_capacity=32, init_window=2,
                            orb=tfeat.OrbParams(max_features=16)),
            jvj.VoJitParams(map_capacity=32, init_window=2,
                            orb=jfeat.OrbParams(max_features=16)))


def _filled_state(seed=3):
    tp, _ = _jit_params()
    s = tvj.vo_init_state(tp, device="cpu", seed=seed)
    rng = np.random.default_rng(0)
    d = convert.state_to_numpy(s)
    d["map_desc"] = rng.integers(0, 2 ** 32, size=d["map_desc"].shape,
                                 dtype=np.uint64).astype(np.uint32)
    d["map_pos"] = rng.normal(size=d["map_pos"].shape).astype(np.float32)
    d["map_valid"][::3] = True
    d["step"] = np.int32(7)
    return convert.state_from_numpy(d, device="cpu", seed=seed), tp


def test_vo_jit_state_round_trip_continues_the_draws(tmp_path):
    s, tp = _filled_state()
    torch.rand(5, generator=s.generator)           # the stream has advanced
    path = str(tmp_path / "jit.npz")
    tck.save_vo_jit_state(s, path)
    back = tck.load_vo_jit_state(path, tvj.vo_init_state(tp, device="cpu"))
    a, b = convert.state_to_numpy(s), convert.state_to_numpy(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    assert torch.equal(torch.rand(4, generator=s.generator),
                       torch.rand(4, generator=back.generator))
    other = tvj.VoJitParams(map_capacity=64, init_window=2,
                            orb=tfeat.OrbParams(max_features=16))
    with pytest.raises(ValueError, match="map_pos"):
        tck.load_vo_jit_state(path, tvj.vo_init_state(other, device="cpu"))


def test_vo_jit_state_crosses_between_packages(tmp_path):
    """Either package loads the other's file; the stream of draws is what
    cannot cross: the JAX package gets the key of the generator's initial
    seed, the port asks for a seed instead of guessing."""
    s, tp = _filled_state(seed=11)
    _, jp = _jit_params()
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tck.save_vo_jit_state(s, tpath)
    js = jck.load_vo_jit_state(tpath, jvj.vo_init_state(jp))
    want = convert.state_to_numpy(s)
    for name in want:
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      want[name], err_msg=name)
        assert np.asarray(getattr(js, name)).dtype == want[name].dtype, name
    np.testing.assert_array_equal(np.asarray(js.key),
                                  np.asarray(jax.random.PRNGKey(11)))
    jck.save_vo_jit_state(js, jpath)
    template = tvj.vo_init_state(tp, device="cpu")
    with pytest.raises(ValueError, match="seed="):
        tck.load_vo_jit_state(jpath, template)
    back = tck.load_vo_jit_state(jpath, template, seed=5)
    got = convert.state_to_numpy(back)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert back.generator.initial_seed() == 5
