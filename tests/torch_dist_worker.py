"""Rank processes for the port's distributed tests (not a pytest module).

``spawn(job, world, tmp_path)`` (or ``start`` then ``finish``) runs
``world`` copies of this script,
each one rank of a gloo process group on the CPU formed through a file
store in ``tmp_path`` (no network, so tests side by side never share a
port), with one torch thread. Each rank reads its inputs from
``tmp_path/inputs.npz`` (numpy arrays, keys prefixed by problem), runs the
job and writes ``tmp_path/out{rank}.npz``. Imports torch, numpy and the
port only.

    python tests/torch_dist_worker.py JOB RANK WORLD TMPDIR
"""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: seconds for a whole spawn: start-up, the group and the solves
TIMEOUT = 120


def start(job: str, world: int, tmp_path, env=None) -> list:
    """Start ``job`` on ``world`` ranks (``tmp_path/inputs.npz`` written)."""
    env = dict(os.environ, **(env or {}))
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for r in range(world)]


def finish(procs: list, tmp_path) -> list[dict]:
    """Wait for the ranks of :func:`start`; their outputs by rank. Raises
    with the output of any rank that failed, and kills what is left."""
    world = len(procs)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {world} failed:\n{out[-4000:]}")
    return [dict(np.load(os.path.join(tmp_path, f"out{r}.npz")))
            for r in range(world)]


def spawn(job: str, world: int, tmp_path, env=None) -> list[dict]:
    """Run ``job`` on ``world`` ranks; their outputs by rank."""
    return finish(start(job, world, tmp_path, env), tmp_path)


def subdict(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def skeleton(n: int = 12, seed: int = 3) -> dict:
    """A ``backend_to_numpy`` dict: ``n`` keyframes on a ring with noisy
    poses, one segment, two loop edges (last -> first, and across) measured
    with noise, so that the optimum keeps a cost."""
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(n) / n
    t = np.stack([3 * np.cos(th), 3 * np.sin(th), 0.1 * np.sin(2 * th)], 1)
    c, s = np.cos(th + np.pi / 2), np.sin(th + np.pi / 2)
    R = np.zeros((n, 3, 3))
    R[:, 0, 0], R[:, 0, 1], R[:, 1, 0], R[:, 1, 1], R[:, 2, 2] = c, -s, s, c, 1
    t_noisy = t + 0.05 * rng.standard_normal((n, 3)) * np.arange(n)[:, None] / n

    def rel(j, i):
        return R[j].T @ R[i], R[j].T @ (t[i] - t[j]) + \
            0.05 * rng.standard_normal(3)

    loops = [(n - 1, 0), (n // 2, 1)]
    return {
        "kf_frame_idx": np.arange(n) * 5, "kf_R": R, "kf_t": t_noisy,
        "kf_num_inliers": np.full(n, 120), "kf_mean_error": np.ones(n),
        "kf_segment": np.zeros(n, np.int64),
        "tracked_since_kf": np.int64(0), "segment": np.int64(0),
        "loop_j": np.array([j for j, _ in loops]),
        "loop_i": np.array([i for _, i in loops]),
        "loop_R": np.stack([rel(j, i)[0] for j, i in loops]),
        "loop_t": np.stack([rel(j, i)[1] for j, i in loops]),
        "loop_inliers": np.array([80, 70]), "loop_s_rel": np.ones(2),
        "raw_frame_idx": np.arange(n) * 5, "raw_segment": np.zeros(n, np.int64),
        "raw_R": R, "raw_t": t_noisy,
    }


def optimize_params(method: str):
    """``optimize()``'s graph parameters for the skeleton: the SE3 graph
    cut to 20 LM iterations (it spends its default 100 on its float64
    floor, where no step meets ``rel_decrease=1e-12``)."""
    from mvslam_tpu_torch.backend import pose_graph as pg
    from mvslam_tpu_torch.backend import sim3_graph as sg

    if method == "se3":
        return pg.PoseGraphParams(max_iterations=20)
    return sg.Sim3GraphParams()


def _job_parallel(rank: int, world: int, inputs: dict) -> dict:
    """Every distributed solver of the port on a 1-D mesh of ``world``."""
    from mvslam_tpu_torch import convert
    from mvslam_tpu_torch.backend import pose_graph as pg
    from mvslam_tpu_torch.ops import ba, ba_sparse
    from mvslam_tpu_torch.parallel import (
        dist_ba, dist_ba_sparse, dist_pose_graph, distributed_ba_solve,
        make_mesh,
    )

    mesh = make_mesh("cpu")
    assert mesh.size() == world and mesh.get_local_rank() == rank
    out = {}
    prob = convert.ba_problem_from_numpy(subdict(inputs, "ba."), device="cpu")
    for name, p in (("ba", prob),
                    ("ba_odd", dist_ba.landmark_block(prob, 0, 250))):
        res = distributed_ba_solve(p, mesh, ba.BAParams())
        out.update({f"{name}.t": res.poses.t, f"{name}.R": res.poses.R,
                    f"{name}.points": res.points,
                    f"{name}.pose_cov": res.pose_covariance,
                    f"{name}.point_cov": res.point_covariance,
                    f"{name}.iterations": res.iterations})
    data = convert.pose_graph_data_from_numpy(subdict(inputs, "pg."),
                                              device="cpu")
    res = dist_pose_graph.distributed_pose_graph_optimize(
        data, mesh, pg.PoseGraphParams())
    out.update({"pg.t": res.poses.t, "pg.R": res.poses.R,
                "pg.iterations": res.iterations})
    data = convert.sim3_graph_data_from_numpy(subdict(inputs, "sim3."),
                                              device="cpu")
    res = dist_pose_graph.distributed_sim3_graph_optimize(data, mesh)
    out.update({"sim3.s": res.poses.s, "sim3.t": res.poses.t,
                "sim3.R": res.poses.R, "sim3.iterations": res.iterations})
    sprob = convert.sparse_ba_problem_from_numpy(subdict(inputs, "sba."),
                                                 device="cpu")
    res = dist_ba_sparse.distributed_sparse_ba_solve(
        sprob, mesh, ba_sparse.SparseBAParams(max_iterations=12,
                                              cg_iterations=40))
    out.update({"sba.t": res.poses.t, "sba.points": res.points,
                "sba.iterations": res.iterations})
    backend = convert.backend_from_numpy(skeleton(), device="cpu")
    for method in ("se3", "sim3"):
        opt = backend.optimize(mesh=mesh, method=method,
                               params=optimize_params(method))
        out[f"optimize.{method}"] = opt.t
        out[f"optimize.{method}.iterations"] = \
            backend.last_result.iterations
    return out


def _job_multihost(rank: int, world: int, inputs: dict) -> dict:
    """The two-process test of the JAX package at the port: a (dcn, ici)
    hybrid mesh whose dcn size comes from LOCAL_WORLD_SIZE, one
    sequence-partitioned sparse solve, and the process-local solve."""
    from mvslam_tpu_torch import convert
    from mvslam_tpu_torch.ops import ba_sparse
    from mvslam_tpu_torch.parallel import multihost
    from mvslam_tpu_torch.parallel.dist_ba_sparse import (
        distributed_sparse_ba_solve_hybrid,
    )

    mesh = multihost.make_hybrid_mesh("cpu")
    prob = convert.sparse_ba_problem_from_numpy(subdict(inputs, "sba."),
                                                device="cpu")
    params = ba_sparse.SparseBAParams(max_iterations=12, cg_iterations=40)
    res = distributed_sparse_ba_solve_hybrid(prob, mesh, params)
    local = ba_sparse.sparse_ba_solve(prob, params)
    return {"mesh_shape": np.array(mesh.shape),
            "mesh_rows": mesh.mesh.numpy(),
            "coordinate": np.array(mesh.get_coordinate()),
            "t": res.poses.t, "points": res.points,
            "iterations": res.iterations, "local_t": local.poses.t,
            "local_iterations": local.iterations}


JOBS = {"parallel": _job_parallel, "multihost": _job_multihost}


def main(job: str, rank: int, world: int, tmp: str) -> int:
    import torch

    from mvslam_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    active = multihost.initialize(
        init_method=f"file://{os.path.join(tmp, 'store')}",
        world_size=world, rank=rank, device_type="cpu")
    assert active == (world > 1)
    inputs = dict(np.load(os.path.join(tmp, "inputs.npz")))
    try:
        out = JOBS[job](rank, world, inputs)
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(tmp, f"out{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                          sys.argv[4]))
