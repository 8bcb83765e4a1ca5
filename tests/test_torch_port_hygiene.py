"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its numpy copies (scene renderer, rBRIEF pattern) equal the
originals; its state converter round-trips."""

import os
import subprocess
import sys

import numpy as np
import torch

from helpers import render_planes_sequence as render_reference
from mvslam_tpu.ops import features as jf
from mvslam_tpu_torch.convert import state_from_numpy, state_to_numpy
from mvslam_tpu_torch.frontend.vo_jit import VoJitParams, vo_init_state
from mvslam_tpu_torch.ops import features as tf
from mvslam_tpu_torch.utils.scene import render_planes_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import mvslam_tpu_torch, mvslam_tpu_torch.frontend.vo_jit\n"
        "import mvslam_tpu_torch.convert, mvslam_tpu_torch.ops.features_cuda\n"
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
    s = vo_init_state(params, seed=3)
    rng = np.random.default_rng(0)
    d = state_to_numpy(s)
    d["map_desc"] = rng.integers(0, 2 ** 32, size=d["map_desc"].shape,
                                 dtype=np.uint64).astype(np.uint32)
    d["map_pos"] = rng.normal(size=d["map_pos"].shape).astype(np.float32)
    d["map_valid"][::3] = True
    back = state_to_numpy(state_from_numpy(d))
    assert back.keys() == d.keys()
    for k in d:
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)
        assert back[k].dtype == d[k].dtype, k
    # descriptor words cross as the same bits
    t = state_from_numpy(d)
    assert t.map_desc.dtype == torch.int32
    np.testing.assert_array_equal(t.map_desc.numpy().view(np.uint32),
                                  d["map_desc"])
