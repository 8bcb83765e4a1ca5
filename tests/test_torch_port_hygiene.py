"""The PyTorch port stands alone: no module of it (nor the scripts at the
root that drive it) imports JAX or the JAX package, none steps down from
the card to the CPU on its own, its entry points and apps default to the
card, and it exports the JAX package's package-level names;
its numpy copies (scene renderer, rBRIEF pattern) equal the originals; its
state converter round-trips."""

import ast
import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import render_planes_sequence as render_reference
from mvslam_tpu.ops import features as jf
from mvslam_tpu_torch.convert import state_from_numpy, state_to_numpy
from mvslam_tpu_torch.frontend.vo_jit import VoJitParams, vo_init_state
from mvslam_tpu_torch.ops import features as tf
from mvslam_tpu_torch.utils.scene import render_planes_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_SCRIPTS = ("chip_smoke", "k1_device_time", "card_vs_cpu")


def port_modules() -> list[str]:
    """Every module of the port, found by walking its package."""
    import mvslam_tpu_torch

    return ["mvslam_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(mvslam_tpu_torch.__path__,
                                              "mvslam_tpu_torch."))


def port_sources() -> list[str]:
    files = [os.path.join(REPO, f"{name}.py") for name in ROOT_SCRIPTS]
    for base, _, names in os.walk(os.path.join(REPO, "mvslam_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_every_new_module_is_found():
    mods = set(port_modules())
    for name in ("ops.ba_sparse", "parallel.synthetic", "backend.pose_graph",
                 "backend.graph", "backend.sim3_graph", "backend.slam",
                 "apps.visual_odometer", "io.image", "viz.export",
                 "utils.errors", "convert", "config",
                 "math.kalman", "math.signal", "math.state_estimate",
                 "frontend.data_types", "frontend.camera_manager",
                 "frontend.frame_manager", "frontend.image_pair",
                 "frontend.visual_odometer", "io.checkpoint",
                 "utils.indexing", "ops.homography", "ops.calibration",
                 "io.native_loader", "viz.viewer", "utils.fs",
                 "utils.logging", "utils.strings", "utils.sync",
                 "utils.timing", "apps.reconstruct_scene",
                 "apps.calibrate_camera", "apps.demos",
                 "apps.video_capture", "parallel.mesh", "parallel.dist_ba",
                 "parallel.dist_ba_sparse", "parallel.dist_pose_graph",
                 "parallel.multihost"):
        assert f"mvslam_tpu_torch.{name}" in mods, name
    assert len(port_sources()) == len(mods) + len(ROOT_SCRIPTS)


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {port_modules() + list(ROOT_SCRIPTS)!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'mvslam_tpu'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_package_level_names():
    """The names the JAX package exports at its top level and from its
    ``utils``, ``io`` and ``viz`` subpackages, exported by the port's."""
    import mvslam_tpu_torch as port
    from mvslam_tpu_torch import io, utils, viz

    for name in ("config", "lie", "linalg", "SE3", "PinholeCamera"):
        assert getattr(port, name) is not None, name
    assert port.SE3 is port.lie.SE3
    for name in ("Logger", "Logging", "Event", "Lock", "Mutex"):
        assert getattr(utils, name) is not None, name
    for name in ("iter_directory", "load_image_grayscale", "load_image_rgb",
                 "read_manifest", "save_image", "write_manifest",
                 "native_loader"):
        assert getattr(io, name) is not None, name
    for name in ("Visualizer2d", "Visualizer2dParams", "Visualizer3d",
                 "Visualizer3dParams", "draw_keypoints", "draw_matches",
                 "save_scene_ply", "save_trajectory_tum"):
        assert getattr(viz, name) is not None, name


def test_no_source_names_jax_or_the_jax_package():
    """Static check beside the import check: no import statement anywhere
    in the port (function bodies included) names ``jax`` or ``mvslam_tpu``."""
    for path in port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "mvslam_tpu"), (path, name)


def test_no_step_down_from_the_card():
    """Nothing in the package probes for a card to choose a device: a CUDA
    tensor takes the kernel or raises, and entry points take ``device``.
    The scripts at the root probe only to refuse to run without a card."""
    for path in port_sources():
        with open(path) as f:
            src = f.read()
        if os.path.basename(path) in (f"{n}.py" for n in ROOT_SCRIPTS):
            for line in src.splitlines():
                if "is_available()" in line and "raise" not in line:
                    assert line.strip().startswith("if not torch.cuda."), line
        else:
            assert "is_available" not in src, path


def test_scene_renderer_equals_test_fixture():
    ts = np.stack([np.arange(3) * 0.12, 0.02 * np.arange(3), np.zeros(3)], 1)
    kw = dict(h=60, w=80, focal=70.0, bg_slope=0.18,
              yaws=np.array([0.0, 0.01, -0.02]))
    np.testing.assert_array_equal(render_planes_sequence(ts, **kw),
                                  render_reference(ts, **kw))


def test_brief_pattern_equals_jax_package():
    np.testing.assert_array_equal(tf._PATTERN, jf._PATTERN)


def test_state_round_trip():
    params = VoJitParams(map_capacity=16, init_window=2,
                         orb=tf.OrbParams(max_features=8))
    s = vo_init_state(params, device="cpu", seed=3)
    rng = np.random.default_rng(0)
    d = state_to_numpy(s)
    d["map_desc"] = rng.integers(0, 2 ** 32, size=d["map_desc"].shape,
                                 dtype=np.uint64).astype(np.uint32)
    d["map_pos"] = rng.normal(size=d["map_pos"].shape).astype(np.float32)
    d["map_valid"][::3] = True
    back = state_to_numpy(state_from_numpy(d, device="cpu"))
    assert back.keys() == d.keys()
    for k in d:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
        assert back[k].dtype == d[k].dtype, k
    # descriptor words cross as the same bits
    t = state_from_numpy(d, device="cpu")
    assert t.map_desc.dtype == torch.int32
    np.testing.assert_array_equal(t.map_desc.numpy().view(np.uint32),
                                  d["map_desc"])


def _entry_points():
    from mvslam_tpu_torch import convert
    from mvslam_tpu_torch.backend.graph import Graph
    from mvslam_tpu_torch.backend.slam import PoseGraphBackend
    from mvslam_tpu_torch.frontend import (
        CameraManager, FrameManager, VisualOdometer,
    )
    from mvslam_tpu_torch.apps import calibrate_camera, demos
    from mvslam_tpu_torch.apps import reconstruct_scene
    from mvslam_tpu_torch.parallel import make_mesh, multihost, synthetic

    return [vo_init_state, state_from_numpy, convert.step_out_from_numpy,
            convert.ba_problem_from_numpy, make_mesh,
            multihost.make_hybrid_mesh, multihost.initialize,
            convert.calibration_result_from_numpy,
            reconstruct_scene.reconstruct, calibrate_camera.calibrate_views,
            demos.demo_visual_feature, demos.demo_visualizer_2d,
            demos.demo_visualizer_3d,
            convert.sparse_ba_problem_from_numpy,
            convert.pose_graph_data_from_numpy,
            convert.sim3_graph_data_from_numpy, convert.backend_from_numpy,
            convert.feature_set_from_numpy, convert.frame_from_numpy,
            PoseGraphBackend.__init__, Graph.__init__,
            VisualOdometer.__init__, FrameManager.__init__,
            CameraManager.__init__,
            synthetic.make_sequence_ba_problem,
            synthetic.make_window_ba_problem]


@pytest.mark.parametrize("entry", _entry_points(),
                         ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(entry):
    """The port's entry points build state on the card unless the caller
    names another device (the meshes and the process group: another device
    type); they do not probe for one."""
    params = inspect.signature(entry).parameters
    name = "device" if "device" in params else "device_type"
    assert params[name].default == "cuda"


def test_front_end_builds_on_the_device_it_is_given():
    """``VisualOdometer()`` and ``FrameManager()`` sit on ``cuda`` unless
    told otherwise; told ``cpu``, every tensor they hold is there, but for
    the FPS filter, which is on the CPU by design."""
    from mvslam_tpu_torch.frontend import FrameManager, VisualOdometer

    for cls in (VisualOdometer, FrameManager):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    vo = VisualOdometer(device="cpu")
    assert vo.device.type == "cpu"
    for name in ("positions", "desc", "templates", "valid", "last_seen"):
        assert getattr(vo._map, name).device.type == "cpu"
    assert vo._map.desc.dtype == torch.int32
    assert vo._map.last_seen.dtype == torch.int64
    fm = FrameManager(device="cpu")
    assert fm.camera.K.device.type == "cpu"


@pytest.mark.parametrize("app", ["reconstruct_scene", "calibrate_camera",
                                 "demos", "visual_odometer"])
def test_apps_take_device_defaulting_to_the_card(app):
    """Each app that computes parses ``--device``, default ``cuda``."""
    import importlib

    src = inspect.getsource(importlib.import_module(
        f"mvslam_tpu_torch.apps.{app}").main)
    assert 'ap.add_argument("--device", default="cuda",' in src


@pytest.mark.parametrize("flags,runner", [
    (["--pose-graph"], "_run_pose_graph"), ([], "_run_visual_odometer")])
def test_app_defaults_to_the_card(monkeypatch, tmp_path, flags, runner):
    from mvslam_tpu_torch.apps import visual_odometer as app

    seen = []
    monkeypatch.setattr(app, runner,
                        lambda args, cam, paths: seen.append(args.device) or 0)
    (tmp_path / "camera.config").write_text("1 1 0 0 0\n0 0 0 0 0 0\n")
    (tmp_path / "image.txt").write_text("a.png\n")
    assert app.main([str(tmp_path), *flags]) == 0
    assert seen == ["cuda"]
