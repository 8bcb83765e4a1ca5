"""The port's multi-process runtime (``parallel/multihost.py``): the
counterpart of ``tests/test_multiprocess.py`` and its worker, as four
gloo ranks on the CPU (``torch_dist_worker.py``) joined through
``multihost.initialize`` on a file store, a (dcn=2, ici=2) hybrid mesh
whose dcn size comes from torchrun's ``LOCAL_WORLD_SIZE``, one
sequence-partitioned sparse solve reduced over both axes, and the
process-local solve, at the worker's size (16 frames x 8 points per frame,
window 4, float64, 12 LM x 40 CG).
"""

import numpy as np
import pytest
import torch

import torch_dist_worker as w
from mvslam_tpu_torch import convert
from mvslam_tpu_torch.parallel.synthetic import make_sequence_ba_problem


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    prob, poses_true, _ = make_sequence_ba_problem(
        11, num_frames=16, points_per_frame=8, window=4, dtype=torch.float64,
        device="cpu")
    tmp = tmp_path_factory.mktemp("multihost")
    np.savez(tmp / "inputs.npz", **{
        "sba." + k: v for k, v in convert.problem_to_numpy(prob).items()})
    return w.spawn("multihost", 4, tmp, env={"LOCAL_WORLD_SIZE": "2"}), \
        poses_true.t.numpy()


def test_hybrid_mesh_rows_are_contiguous_rank_blocks(run):
    ranks, _ = run
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["mesh_shape"], [2, 2])
        np.testing.assert_array_equal(out["mesh_rows"], [[0, 1], [2, 3]])
        np.testing.assert_array_equal(out["coordinate"], [r // 2, r % 2])


def test_hybrid_solve_matches_the_local_solve(run):
    """Within 1e-8 of the process-local solve on every rank, the same
    iterations everywhere, and within 0.2 of truth (the monocular gauge
    leaves a bounded drift mode)."""
    ranks, t_true = run
    for out in ranks:
        assert np.abs(out["t"] - out["local_t"]).max() < 1e-8
        assert int(out["iterations"]) == int(out["local_iterations"])
        assert np.abs(out["t"] - t_true).max() < 0.2
        np.testing.assert_array_equal(out["t"], ranks[0]["t"])
        np.testing.assert_array_equal(out["points"], ranks[0]["points"])
    assert ranks[0]["points"].shape == (128, 3)
