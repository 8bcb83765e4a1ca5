"""The JAX package's own back-end bars, rerun on the port: the truth-recovery
and masking cases of ``tests/test_pose_graph.py``, all of
``tests/test_sim3_graph.py`` and the single-process cases of
``tests/test_ba_sparse.py``, on ``mvslam_tpu_torch.backend.{graph,
pose_graph,sim3_graph}``, ``ops.ba_sparse`` and ``parallel.multihost``.

Each case draws the reference's problem from the same seed (the noisy
triangle with its loop edge, the scale-drifted chain, the JAX package's own
sparse problems converted through ``convert``), holds the port to the
reference's bar in float64 and float32 where the reference runs both, and
compares the port's optimum with the JAX package's on the same inputs.
(a) rerun here; (b) an existing test already asserts the bar; (c) not
applicable.

| reference case | | where |
|---|---|---|
| `test_pose_graph.py::test_loop_closure_recovers_trajectory` | a | `test_loop_closure_recovers_trajectory` |
| `test_pose_graph.py::test_optimizer_copy_until_update` | b | `test_torch_pose_graph.py::test_graph_optimizer_matches_and_copies_until_update` |
| `test_pose_graph.py::test_origin_stays_anchored` | a | `test_origin_stays_anchored` |
| `test_pose_graph.py::test_unknown_node_edge_raises` | b | `test_torch_pose_graph.py::test_merge_from_set_anchor_and_unknown_nodes` |
| `test_pose_graph.py::test_merge_from` | b | `test_torch_pose_graph.py::test_merge_from_set_anchor_and_unknown_nodes` |
| `test_pose_graph.py::test_capacity_padding_masks_inactive` | a | `test_capacity_padding_masks_inactive` (the port's `Graph.to_data` does not pad: the padding is appended to its data here) |
| `test_sim3_graph.py::test_sim3_group_ops` | a | `test_sim3_group_ops` |
| `test_sim3_graph.py::test_sim3_chain_recovers_scale_drift` | a | `test_sim3_chain_recovers_scale_drift` (float64: the reference skips float32) |
| `test_sim3_graph.py::test_sim3_huber_downweights_outlier_edge` | a | `test_sim3_huber_downweights_outlier_edge` (float64, as the reference) |
| `test_ba_sparse.py::test_sparse_matches_dense_oracle` | a | `test_sparse_matches_dense_oracle` (on JAX's own problem; on the port's generator: `test_torch_ba_sparse.py::test_sparse_lands_on_the_dense_optimum`) |
| `test_ba_sparse.py::test_sparse_sequence_recovers_truth` | a | `test_sparse_sequence_recovers_truth` |
| `test_ba_sparse.py::test_sequence_partition_1_vs_8_shards` | b | `test_torch_parallel.py::test_distributed_sparse_ba_matches_single_device` (four gloo ranks) |
| `test_ba_sparse.py::test_sparse_large_scale_distributed` | b | `test_torch_parallel.py::test_distributed_sparse_ba_matches_single_device`; the 102,400-landmark size: `chip_smoke.py` `sparse ba` on the card |
| `test_ba_sparse.py::test_hybrid_dcn_ici_mesh_matches_single_device` | b | `test_torch_multihost.py::test_hybrid_solve_matches_the_local_solve` (a (2, 2) mesh of four gloo ranks) |
| `test_ba_sparse.py::test_hybrid_mesh_single_process_fallback` | a | `test_hybrid_mesh_single_process_fallback` |
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mvslam_tpu.backend import Graph as JGraph
from mvslam_tpu.backend import pose_graph as jpg
from mvslam_tpu.backend import sim3_graph as jsg
from mvslam_tpu.math.lie import SE3 as JSE3
from mvslam_tpu.ops import ba_sparse as jbs
from mvslam_tpu.parallel.synthetic import (
    make_sequence_ba_problem as jax_sequence_problem,
)
from mvslam_tpu_torch import convert
from mvslam_tpu_torch.backend import pose_graph as pg
from mvslam_tpu_torch.backend import sim3_graph as sg
from mvslam_tpu_torch.backend.graph import Graph, GraphOptimizer
from mvslam_tpu_torch.math.lie import SE3, so3_from_rpy
from mvslam_tpu_torch.ops import ba as ba_mod
from mvslam_tpu_torch.ops import ba_sparse
from mvslam_tpu_torch.parallel import multihost

from test_torch_ref_common import DTYPES, Dt, check_similar_se3
from test_torch_ref_common import one_torch_thread  # noqa: F401 (autouse)

RECOVERY_TOL = 0.03      # test_pose_graph.py
EDGE_NOISE = 0.01        # test_pose_graph.py
#: the port's optimum against JAX's on the same graph, componentwise |ln|:
#: float32 LM rounding on a 7-node graph (test_torch_pose_graph.py's
#: OPT_ATOL of the 12-node ring)
OPT_ATOL = {"float32": 2e-4, "float64": 1e-7}


pose_graph_optimize_j = jax.jit(jpg.pose_graph_optimize)
sim3_optimize_j = jax.jit(jsg.sim3_graph_optimize, static_argnames=("params",))
sparse_solve_j = jax.jit(jbs.sparse_ba_solve, static_argnames=("params",))


@pytest.fixture(params=DTYPES)
def dt(request):
    return Dt(request.param)


# -- tests/test_pose_graph.py ----------------------------------------------


def triangle_trajectory(dt: Dt) -> list:
    """Ground truth marching around a triangle, two steps per side."""
    step = SE3(torch.eye(3, dtype=dt.torch), dt.t([1.0, 0.0, 0.0]))
    turn = SE3(so3_from_rpy(0.0, 0.0, 2.0 * np.pi / 3.0, dtype=dt.torch),
               torch.zeros(3, dtype=dt.torch))
    poses = [SE3.identity(dtype=dt.torch)]
    for _ in range(3):
        poses.append(poses[-1].compose(step))
        poses.append(poses[-1].compose(turn))
    return poses


def build_noisy_graphs(dt: Dt, rng):
    """The reference's dead-reckoned triangle with noisy odometry and a true
    loop edge, as a port ``Graph`` and a JAX ``Graph`` from the same
    draws."""
    gt = triangle_trajectory(dt)
    covar = (EDGE_NOISE ** 2) * np.eye(6)
    graph = Graph(origin=gt[0], dtype=dt.torch, device="cpu")
    jgraph = JGraph(origin=JSE3(dt.j(gt[0].R), dt.j(gt[0].t)), dtype=dt.jnp)
    ids = [graph.origin_id]
    guess = gt[0]
    for k in range(1, len(gt)):
        rel_true = gt[k - 1].inverse().compose(gt[k])
        rel = rel_true.compose(SE3.exp(dt.t(rng.normal(0, EDGE_NOISE, 6))))
        guess = guess.compose(rel)
        jrel = JSE3(dt.j(rel.R), dt.j(rel.t))
        ids.append(graph.add_pose_node(guess))
        assert jgraph.add_pose_node(JSE3(dt.j(guess.R), dt.j(guess.t))) \
            == ids[-1]
        graph.add_transformation_edge(ids[k - 1], ids[k], rel, covar)
        jgraph.add_transformation_edge(ids[k - 1], ids[k], jrel, covar)
    rel_loop = gt[-1].inverse().compose(gt[0])
    graph.add_transformation_edge(ids[-1], ids[0], rel_loop, covar)
    jgraph.add_transformation_edge(ids[-1], ids[0],
                                   JSE3(dt.j(rel_loop.R), dt.j(rel_loop.t)),
                                   covar)
    return graph, jgraph, gt, ids


def _as64(T: SE3) -> SE3:
    return T.to(torch.float64)


def _jax_pose(T) -> SE3:
    return SE3(torch.from_numpy(np.array(T.R, np.float64)),
               torch.from_numpy(np.array(T.t, np.float64)))


def _jax_optimum(jgraph, node_id: int) -> SE3:
    """What the JAX ``GraphOptimizer`` returns for ``node_id`` (its solve,
    compiled once per shape instead of run op by op)."""
    res = pose_graph_optimize_j(jgraph.to_data())
    return _jax_pose(JSE3(res.poses.R[node_id], res.poses.t[node_id]))


def test_loop_closure_recovers_trajectory(dt):
    rng = np.random.default_rng(0)
    graph, jgraph, gt, ids = build_noisy_graphs(dt, rng)
    opt = GraphOptimizer(graph)
    err = opt.optimize()
    assert np.isfinite(err)
    for node_id, gt_pose in zip(ids, gt):
        got = opt.get_optimized_pose(node_id)
        assert got.t.dtype == dt.torch
        assert check_similar_se3(_as64(got), _as64(gt_pose), RECOVERY_TOL)
        assert check_similar_se3(_as64(got), _jax_optimum(jgraph, node_id),
                                 OPT_ATOL[dt.name])


def test_origin_stays_anchored(dt):
    rng = np.random.default_rng(4)
    graph, jgraph, gt, ids = build_noisy_graphs(dt, rng)
    opt = GraphOptimizer(graph)
    opt.optimize()
    origin = opt.get_optimized_pose(graph.origin_id)
    assert check_similar_se3(_as64(origin), _as64(gt[0]), 1e-3)
    assert check_similar_se3(_as64(origin),
                             _jax_optimum(jgraph, graph.origin_id),
                             OPT_ATOL[dt.name])


def _pad(data: pg.PoseGraphData, node_capacity: int,
         edge_capacity: int) -> pg.PoseGraphData:
    """``data`` padded as the JAX ``Graph.to_data(node_capacity,
    edge_capacity)`` pads: identity poses and edges, masked out, no prior
    on the padding nodes."""
    n, e = data.poses.t.shape[0], data.edge_src.shape[0]
    dn, de = node_capacity - n, edge_capacity - e
    dtype = data.poses.t.dtype

    def eye(k, d):
        return torch.eye(d, dtype=dtype).expand(k, d, d)

    def se3(T, k):
        return SE3(torch.cat([T.R, eye(k, 3)]),
                   torch.cat([T.t, torch.zeros((k, 3), dtype=dtype)]))

    zeros = torch.zeros
    return pg.PoseGraphData(
        poses=se3(data.poses, dn),
        node_mask=torch.cat([data.node_mask, zeros(dn, dtype=torch.bool)]),
        edge_src=torch.cat([data.edge_src, zeros(de, dtype=torch.int64)]),
        edge_dst=torch.cat([data.edge_dst, zeros(de, dtype=torch.int64)]),
        edge_rel=se3(data.edge_rel, de),
        edge_info=torch.cat([data.edge_info, eye(de, 6)]),
        edge_mask=torch.cat([data.edge_mask, zeros(de, dtype=torch.bool)]),
        prior_pose=se3(data.prior_pose, dn),
        prior_info=torch.cat([data.prior_info, zeros((dn, 6, 6),
                                                     dtype=dtype)]))


def test_capacity_padding_masks_inactive(dt):
    rng = np.random.default_rng(6)
    graph, jgraph, gt, ids = build_noisy_graphs(dt, rng)
    data = _pad(graph.to_data(), 32, 64)
    res = pg.pose_graph_optimize(data)
    jres = pose_graph_optimize_j(
        jgraph.to_data(node_capacity=32, edge_capacity=64))
    for node_id, gt_pose in zip(ids, gt):
        got = SE3(res.poses.R[node_id], res.poses.t[node_id])
        assert check_similar_se3(_as64(got), _as64(gt_pose), RECOVERY_TOL)
        want = _jax_pose(JSE3(jres.poses.R[node_id], jres.poses.t[node_id]))
        assert check_similar_se3(_as64(got), want, OPT_ATOL[dt.name])
    # the padding stays where it was put
    np.testing.assert_array_equal(res.poses.t[len(ids):].numpy(), 0.0)


# -- tests/test_sim3_graph.py -----------------------------------------------


def test_sim3_group_ops(dt):
    rng = np.random.default_rng(3)
    delta = dt.t(rng.normal(0, 0.3, 7))
    T = sg.Sim3.identity(dtype=dt.torch).retract(delta)
    atol = 1e-12 if dt.f64 else 1e-5
    np.testing.assert_allclose(T.chart_log().numpy(), delta.numpy(),
                               atol=atol)
    jT = jsg.Sim3.identity(dtype=dt.jnp).retract(dt.j(delta))
    np.testing.assert_allclose(T.t.numpy(), np.asarray(jT.t), atol=atol)
    I = T.compose(T.inverse())
    np.testing.assert_allclose(I.s.numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(I.R.numpy(), np.eye(3), atol=1e-5)
    np.testing.assert_allclose(I.t.numpy(), 0.0, atol=1e-5)
    x = dt.t(rng.normal(0, 1, 3))
    T2 = sg.Sim3.identity(dtype=dt.torch).retract(dt.t(rng.normal(0, 0.3, 7)))
    lhs = T.compose(T2).apply(x)
    np.testing.assert_allclose(lhs.numpy(), T.apply(T2.apply(x)).numpy(),
                               atol=1e-5)
    jT2 = jsg.Sim3(dt.j(T2.s), dt.j(T2.R), dt.j(T2.t))
    np.testing.assert_allclose(lhs.numpy(),
                               np.asarray(jT.compose(jT2).apply(dt.j(x))),
                               atol=1e-5)


def _drifted_chain(n=8, drift=0.03):
    """``test_sim3_graph.py::_drifted_chain``: positions on a line, a
    geometric per-node scale drift, local-metric odometry, and the
    dead-reckoned initial positions."""
    p_true = np.stack([np.arange(n, dtype=np.float64), np.zeros(n),
                       np.zeros(n)], 1)
    s_true = (1.0 + drift) ** np.arange(n)
    rels = [(p_true[k + 1] - p_true[k]) / s_true[k] for k in range(n - 1)]
    p_init = np.zeros((n, 3))
    for k in range(n - 1):
        p_init[k + 1] = p_init[k] + rels[k]
    return p_true, s_true, p_init, rels


def _sim3_data(dt: Dt, p_init, src, dst, rel_s, rel_t, info):
    """The same chain as the port's and as the JAX package's graph data."""
    N, E = len(p_init), len(src)
    eye3 = np.tile(np.eye(3), (max(N, E), 1, 1))
    prior_info = np.zeros((N, 7, 7))
    prior_info[0] = np.eye(7) * 1e8
    d = {"poses.s": np.ones(N), "poses.R": eye3[:N], "poses.t": p_init,
         "node_mask": np.ones(N, bool), "edge_src": src, "edge_dst": dst,
         "edge_rel.s": rel_s, "edge_rel.R": eye3[:E], "edge_rel.t": rel_t,
         "edge_info": info, "edge_mask": np.ones(E, bool),
         "prior_pose.s": np.ones(N), "prior_pose.R": eye3[:N],
         "prior_pose.t": p_init, "prior_info": prior_info}
    d = {k: (v.astype(dt.np) if v.dtype == np.float64 else v)
         for k, v in d.items()}

    def j3(name):
        return jsg.Sim3(jnp.asarray(d[f"{name}.s"]), jnp.asarray(d[f"{name}.R"]),
                        jnp.asarray(d[f"{name}.t"]))

    jdata = jsg.Sim3GraphData(
        poses=j3("poses"), node_mask=jnp.asarray(d["node_mask"]),
        edge_src=jnp.asarray(src, jnp.int32),
        edge_dst=jnp.asarray(dst, jnp.int32), edge_rel=j3("edge_rel"),
        edge_info=jnp.asarray(d["edge_info"]),
        edge_mask=jnp.asarray(d["edge_mask"]), prior_pose=j3("prior_pose"),
        prior_info=jnp.asarray(d["prior_info"]))
    return convert.sim3_graph_data_from_numpy(d, device="cpu"), jdata


def test_sim3_chain_recovers_scale_drift():
    dt = Dt("float64")
    n = 8
    p_true, s_true, p_init, rels = _drifted_chain(n)
    E = n
    src = np.arange(E, dtype=np.int64)
    dst = np.arange(1, E + 1, dtype=np.int64)
    rel_t = np.zeros((E, 3))
    rel_s = np.ones(E)
    info = np.tile(np.eye(7), (E, 1, 1))
    for k in range(n - 1):
        rel_t[k] = rels[k]
        info[k] = np.diag(1.0 / np.concatenate([
            np.full(3, 1e-3), np.full(3, 1e-3), [0.05]]) ** 2)
    src[-1], dst[-1] = 0, n - 1
    rel_t[-1] = (p_true[-1] - p_true[0]) / s_true[0]
    rel_s[-1] = s_true[-1] / s_true[0]
    info[-1] = np.diag(1.0 / np.concatenate([
        np.full(3, 1e-3), np.full(3, 1e-3), [0.01]]) ** 2)
    data, jdata = _sim3_data(dt, p_init, src, dst, rel_s, rel_t, info)
    assert float(np.linalg.norm(p_init[-1] - p_true[-1])) > 0.5
    res = sg.sim3_graph_optimize(data, sg.Sim3GraphParams())
    assert bool(res.converged)
    t_opt, s_opt = res.poses.t.numpy(), res.poses.s.numpy()
    assert float(np.linalg.norm(t_opt[-1] - p_true[-1])) < 0.05
    np.testing.assert_allclose(s_opt, s_true, rtol=0.03)
    jres = sim3_optimize_j(jdata, params=jsg.Sim3GraphParams())
    np.testing.assert_allclose(t_opt, np.asarray(jres.poses.t), atol=1e-9)
    np.testing.assert_allclose(s_opt, np.asarray(jres.poses.s), atol=1e-9)


def test_sim3_huber_downweights_outlier_edge():
    dt = Dt("float64")
    n = 6
    p_true, _, p_init, rels = _drifted_chain(n, drift=0.0)
    E = (n - 1) + 2
    src = np.zeros(E, np.int64)
    dst = np.zeros(E, np.int64)
    rel_t = np.zeros((E, 3))
    info = np.tile(np.eye(7), (E, 1, 1)) / 0.01 ** 2
    for k in range(n - 1):
        src[k], dst[k] = k, k + 1
        rel_t[k] = rels[k]
    src[-2], dst[-2] = 0, n - 1
    rel_t[-2] = p_true[-1] - p_true[0]
    src[-1], dst[-1] = 0, n - 1
    rel_t[-1] = p_true[-1] - p_true[0] + np.asarray([2.0, -1.5, 0.7])
    data, jdata = _sim3_data(dt, p_init, src, dst, np.ones(E), rel_t, info)
    errs = {}
    for huber in (None, 2.0):
        res = sg.sim3_graph_optimize(data, sg.Sim3GraphParams(
            huber_delta=huber))
        jres = sim3_optimize_j(jdata, params=jsg.Sim3GraphParams(
            huber_delta=huber))
        np.testing.assert_allclose(res.poses.t.numpy(),
                                   np.asarray(jres.poses.t), atol=1e-9)
        errs[huber] = float(np.linalg.norm(res.poses.t[-1].numpy()
                                           - p_true[-1]))
    assert errs[2.0] < errs[None] / 3, errs
    assert errs[2.0] < 0.05, errs


# -- tests/test_ba_sparse.py: the single-process cases ----------------------


def _jax_problem_for_the_port(seed: int, num_frames: int,
                              points_per_frame: int):
    """The reference's own sparse problem (JAX's generator and key), and
    the same arrays as the port's problem."""
    jprob, poses_true, _ = jax_sequence_problem(
        jax.random.PRNGKey(seed), num_frames=num_frames,
        points_per_frame=points_per_frame, window=4, dtype=jnp.float64)
    prob = convert.sparse_ba_problem_from_numpy(
        convert.problem_to_numpy(jprob), device="cpu")
    return prob, jprob, np.asarray(poses_true.t)


def test_sparse_matches_dense_oracle():
    prob, jprob, _ = _jax_problem_for_the_port(0, 8, 24)
    dense = ba_mod.ba_solve(
        ba_sparse.densify(prob),
        ba_mod.BAParams(max_iterations=40, compute_covariance=False))
    sparse = ba_sparse.sparse_ba_solve(
        prob, ba_sparse.SparseBAParams(max_iterations=40, cg_iterations=60))
    np.testing.assert_allclose(sparse.poses.t.numpy(), dense.poses.t.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(sparse.points.numpy(), dense.points.numpy(),
                               atol=1e-5)
    assert abs(float(sparse.error) - float(dense.error)) < 1e-4 * (
        1.0 + float(dense.error))
    jsparse = sparse_solve_j(
        jprob, params=jbs.SparseBAParams(max_iterations=40, cg_iterations=60))
    # float64, the same problem: test_torch_ba_sparse.py's SOLVE_TOL
    np.testing.assert_allclose(sparse.poses.t.numpy(),
                               np.asarray(jsparse.poses.t), atol=1e-9 * 7.5)


def test_sparse_sequence_recovers_truth():
    prob, jprob, t_true = _jax_problem_for_the_port(1, 64, 16)
    res = ba_sparse.sparse_ba_solve(
        prob, ba_sparse.SparseBAParams(max_iterations=30, cg_iterations=80))
    assert bool(res.converged)
    dense = ba_mod.ba_solve(
        ba_sparse.densify(prob),
        ba_mod.BAParams(max_iterations=30, compute_covariance=False))
    d = np.abs(res.poses.t.numpy() - dense.poses.t.numpy()).max()
    assert d < 2e-3, d
    abs_err = np.abs(res.poses.t.numpy() - t_true).max()
    assert abs_err < 0.2, abs_err
    jres = sparse_solve_j(
        jprob, params=jbs.SparseBAParams(max_iterations=30, cg_iterations=80))
    assert np.abs(res.poses.t.numpy() - np.asarray(jres.poses.t)).max() \
        < 2e-3


def test_hybrid_mesh_single_process_fallback(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert multihost.initialize(device_type="cpu") is False
    try:
        mesh = multihost.make_hybrid_mesh("cpu")
        assert mesh.mesh_dim_names == (multihost.DCN_AXIS,
                                       multihost.ICI_AXIS)
        assert tuple(mesh.shape) == (1, dist.get_world_size()) == (1, 1)
        with pytest.raises(ValueError):
            multihost.make_hybrid_mesh("cpu", dcn_size=3)
    finally:
        dist.destroy_process_group()
