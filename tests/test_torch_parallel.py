"""The port's distributed layer (``mvslam_tpu_torch/parallel``) on four
gloo ranks on the CPU (``torch_dist_worker.py``: a file store, one torch
thread per rank) against one rank and against the JAX package's
single-device solves of the same problems, in float64 with the bars of
``tests/test_parallel.py``: the dense window BA and its odd landmark count,
the SE3 graph with an odd edge capacity, and beside them the Sim3 graph,
the sparse sequence solve and ``PoseGraphBackend.optimize(mesh=...)``.
Every rank must leave each LM loop at the same iteration. At world size 1
(a one-rank group formed in this process) the distributed solves equal the
ungrouped ones bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import test_pose_graph as jtpg
import torch_dist_worker as w
from mvslam_tpu.ops import ba as jba
from mvslam_tpu.parallel import dist_pose_graph as jdpg
from mvslam_tpu.parallel import multihost as jmh
from mvslam_tpu.parallel import synthetic as jsyn
from mvslam_tpu_torch import convert
from mvslam_tpu_torch.backend import pose_graph as pg
from mvslam_tpu_torch.backend import sim3_graph as sg
from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops import ba, ba_sparse
from mvslam_tpu_torch.parallel import (
    dist_ba, dist_ba_sparse, dist_pose_graph, make_mesh, mesh as tmesh,
    multihost,
)
from mvslam_tpu_torch.parallel.synthetic import make_sequence_ba_problem
from test_torch_sim3_graph import jax_data as sim3_jax_data
from test_torch_sim3_graph import ring_arrays as sim3_ring

WORLD = 4
SBA_PARAMS = dict(max_iterations=12, cg_iterations=40)


@pytest.fixture(scope="module")
def inputs():
    """The problems as numpy dicts: the dense window of
    ``tests/test_parallel.py`` drawn by the JAX package (PRNG key 0), its
    SE3 graph (the noisy triangle of ``tests/test_pose_graph.py``, edge
    capacity 10), the Sim3 ring of ``test_torch_sim3_graph.py`` and the
    port's own sparse sequence (numpy seed 11, the size of
    ``tests/multiprocess_worker.py``)."""
    prob, poses_true, pts_true = jsyn.make_window_ba_problem(
        jax.random.PRNGKey(0), num_frames=6, num_points=256,
        dtype=jnp.float64)
    graph, _, _ = jtpg.build_noisy_graph(jnp.float64,
                                         np.random.default_rng(0))
    pg_data = graph.to_data(node_capacity=8, edge_capacity=10)
    sprob, sposes_true, _ = make_sequence_ba_problem(
        11, num_frames=16, points_per_frame=8, window=4, dtype=torch.float64,
        device="cpu")
    d = {}
    for prefix, p in (("ba.", prob), ("pg.", pg_data), ("sba.", sprob)):
        d.update({prefix + k: v for k, v in
                  convert.problem_to_numpy(p).items()})
    d.update({"sim3." + k: v for k, v in sim3_ring("float64").items()})
    truth = {"ba.t": np.asarray(poses_true.t), "ba.R": np.asarray(poses_true.R),
             "ba.points": np.asarray(pts_true),
             "sba.t": np.asarray(sposes_true.t)}
    return d, (prob, pg_data), truth


@pytest.fixture(scope="module")
def launched(inputs, tmp_path_factory):
    """The four ranks, started before the one-rank solves run here."""
    tmp = tmp_path_factory.mktemp("parallel")
    np.savez(tmp / "inputs.npz", **inputs[0])
    return w.start("parallel", WORLD, tmp), tmp


@pytest.fixture(scope="module")
def ranks(launched, single):
    return w.finish(*launched)


def _leaves(x):
    """The tensors of a result tuple, nested transforms flattened."""
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return [] if x is None else [x]


def _port(d, prefix, fn):
    return fn(w.subdict(d, prefix), device="cpu")


@pytest.fixture(scope="module")
def single(inputs, launched):
    """The port's ungrouped solves and, for the dense BA, the JAX
    package's, by output key (``test_torch_pose_graph.py``,
    ``test_torch_sim3_graph.py`` and ``test_torch_ba_sparse.py`` hold the
    other ungrouped solves to JAX)."""
    d, (jprob, _), _ = inputs
    prob = _port(d, "ba.", convert.ba_problem_from_numpy)
    port, ref = {}, {}
    for name, p in (("ba", prob), ("ba_odd",
                                   dist_ba.landmark_block(prob, 0, 250))):
        res = ba.ba_solve(p)
        port.update({f"{name}.t": res.poses.t, f"{name}.R": res.poses.R,
                     f"{name}.points": res.points,
                     f"{name}.pose_cov": res.pose_covariance,
                     f"{name}.iterations": res.iterations})
    res = jba.ba_solve(jprob)
    ref.update({"ba.t": res.poses.t, "ba.R": res.poses.R,
                "ba.points": res.points, "ba.pose_cov": res.pose_covariance,
                "ba.iterations": res.iterations})
    res = pg.pose_graph_optimize(_port(d, "pg.",
                                       convert.pose_graph_data_from_numpy))
    port.update({"pg.t": res.poses.t, "pg.R": res.poses.R,
                 "pg.iterations": res.iterations})
    res = sg.sim3_graph_optimize(_port(d, "sim3.",
                                       convert.sim3_graph_data_from_numpy))
    port.update({"sim3.s": res.poses.s, "sim3.t": res.poses.t,
                 "sim3.R": res.poses.R, "sim3.iterations": res.iterations})
    res = ba_sparse.sparse_ba_solve(
        _port(d, "sba.", convert.sparse_ba_problem_from_numpy),
        ba_sparse.SparseBAParams(**SBA_PARAMS))
    port.update({"sba.t": res.poses.t, "sba.points": res.points,
                 "sba.iterations": res.iterations})
    backend = convert.backend_from_numpy(w.skeleton(), device="cpu")
    for method in ("se3", "sim3"):
        port[f"optimize.{method}"] = backend.optimize(
            method=method, params=w.optimize_params(method)).t
        port[f"optimize.{method}.iterations"] = backend.last_result.iterations
    as_np = {k: np.asarray(v) for k, v in port.items()}
    return as_np, {k: np.asarray(v) for k, v in ref.items()}


def _against_single(ranks, single, keys, atol, rtol=0.0):
    """Every rank's outputs against the port's one-rank solve and, where
    this file runs it (the dense BA), the JAX package's; the same
    iteration count on every rank and in the one-rank solve."""
    port, ref = single
    for r, out in enumerate(ranks):
        for want in (port, ref):
            for k in keys:
                if k in want:
                    np.testing.assert_allclose(
                        out[k], want[k], rtol=rtol, atol=atol,
                        err_msg=f"rank {r} {k}")
        it = keys[0] + ".iterations"
        if it not in port:
            it = keys[0].rsplit(".", 1)[0] + ".iterations"
        assert int(out[it]) == int(port[it]), (r, it)


def test_distributed_ba_recovers_truth(ranks, inputs):
    """``test_single_device_solve_recovers_truth``, at world size 4."""
    truth = inputs[2]
    for out in ranks:
        got = SE3(torch.from_numpy(out["ba.R"]), torch.from_numpy(out["ba.t"]))
        want = SE3(torch.from_numpy(truth["ba.R"]),
                   torch.from_numpy(truth["ba.t"]))
        assert float((got.log() - want.log()).abs().max()) < 5e-3
        assert np.abs(out["ba.points"] - truth["ba.points"]).max() < 0.2


def test_distributed_matches_single_device(ranks, single):
    _against_single(ranks, single, ["ba.t", "ba.R"], atol=1e-8)
    _against_single(ranks, single, ["ba.points"], atol=1e-7)
    _against_single(ranks, single, ["ba.pose_cov"], atol=1e-12, rtol=1e-6)


def test_distributed_pads_odd_point_counts(ranks, single):
    for out in ranks:
        assert out["ba_odd.points"].shape == (250, 3)
        assert out["ba_odd.point_cov"].shape == (250, 3, 3)
    _against_single(ranks, single, ["ba_odd.points"], atol=1e-7)


def test_distributed_pose_graph_matches_single_device(ranks, single):
    """Edge capacity 10 over 4 ranks: two masked edges of padding."""
    _against_single(ranks, single, ["pg.t", "pg.R"], atol=1e-9)


def test_distributed_sim3_graph_matches_single_device(ranks, single):
    _against_single(ranks, single, ["sim3.t", "sim3.R", "sim3.s"], atol=1e-9)


def test_distributed_sparse_ba_matches_single_device(ranks, single, inputs):
    _against_single(ranks, single, ["sba.t", "sba.points"], atol=1e-8)
    for out in ranks:
        assert np.abs(out["sba.t"] - inputs[2]["sba.t"]).max() < 0.2


def test_optimize_with_a_mesh_matches_optimize(ranks, single):
    """``PoseGraphBackend.optimize(mesh=...)`` at world size 4 against
    ``optimize()``, both graphs. The back-end's SE3 system is stiff (loop
    and odometry sigmas of millimetres against metres of ring): the sums'
    order moves its poses by 7.0e-9 (measured), so 2e-8 there."""
    for method, atol in (("se3", 2e-8), ("sim3", 1e-9)):
        _against_single(ranks, single, [f"optimize.{method}"], atol=atol)


@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo group formed in this process by ``make_mesh``,
    destroyed after the test."""
    assert not dist.is_initialized()
    mesh = make_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def test_world_size_one_is_bitwise_the_ungrouped_solve(one_rank_mesh,
                                                       inputs):
    d = inputs[0]
    mesh = one_rank_mesh
    assert mesh.size() == 1 and mesh.mesh_dim_names == (tmesh.DATA_AXIS,)
    prob = _port(d, "ba.", convert.ba_problem_from_numpy)
    a, b = ba.ba_solve(prob), dist_ba.distributed_ba_solve(prob, mesh)
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        assert torch.equal(x, y)
    data = _port(d, "pg.", convert.pose_graph_data_from_numpy)
    a = pg.pose_graph_optimize(data)
    b = dist_pose_graph.distributed_pose_graph_optimize(data, mesh)
    assert torch.equal(a.poses.t, b.poses.t) and a.iterations == b.iterations
    data = _port(d, "sim3.", convert.sim3_graph_data_from_numpy)
    a = sg.sim3_graph_optimize(data)
    b = dist_pose_graph.distributed_sim3_graph_optimize(data, mesh)
    assert torch.equal(a.poses.t, b.poses.t) and torch.equal(a.poses.s,
                                                             b.poses.s)
    sprob = _port(d, "sba.", convert.sparse_ba_problem_from_numpy)
    params = ba_sparse.SparseBAParams(**SBA_PARAMS)
    a = ba_sparse.sparse_ba_solve(sprob, params)
    b = dist_ba_sparse.distributed_sparse_ba_solve(sprob, mesh, params)
    assert torch.equal(a.poses.t, b.poses.t) and torch.equal(a.points,
                                                             b.points)
    backend = convert.backend_from_numpy(w.skeleton(), device="cpu")
    for method in ("se3", "sim3"):
        gp = w.optimize_params(method)
        assert torch.equal(
            backend.optimize(method=method, params=gp).t,
            backend.optimize(mesh=mesh, method=method, params=gp).t)
    assert tmesh.replicated(mesh) == [Replicate()]
    assert tmesh.sharded_leading(mesh) == [Shard(0)]
    hybrid = multihost.make_hybrid_mesh("cpu")
    assert hybrid.mesh_dim_names == ("dcn", "ici") and hybrid.shape == (1, 1)
    with pytest.raises(ValueError):
        multihost.make_hybrid_mesh("cpu", dcn_size=2)
    a = dist_ba_sparse.distributed_sparse_ba_solve_hybrid(sprob, hybrid,
                                                          params)
    assert torch.equal(a.poses.t, b.poses.t)


def test_a_mesh_must_be_a_device_mesh(inputs):
    data = _port(inputs[0], "pg.", convert.pose_graph_data_from_numpy)
    with pytest.raises(TypeError, match="DeviceMesh"):
        dist_pose_graph.distributed_pose_graph_optimize(data, object())


def test_initialize_at_world_size_one(monkeypatch):
    """Nothing to join: False, and no process group is formed."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize(device_type="cpu") is False
    assert multihost.initialize(world_size=1, device_type="cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize() is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("n,size", [(250, 8), (256, 8), (10, 4), (3, 1)])
def test_local_batch_slice_matches_jax(n, size):
    for i in range(size):
        assert multihost.local_batch_slice(n, size, i) == \
            jmh.local_batch_slice(n, size, i)
    assert tmesh.pad_to_multiple(n, size) == size * (-(-n // size))


def test_pads(inputs):
    """Padding to a multiple the axis already has is the identity; other
    padding appends masked rows equal to the JAX package's and leaves the
    solution where it was."""
    d, (jprob, jpg_data), _ = inputs
    prob = _port(d, "ba.", convert.ba_problem_from_numpy)
    assert dist_ba.pad_problem(prob, 8) is prob
    sprob = _port(d, "sba.", convert.sparse_ba_problem_from_numpy)
    assert dist_ba_sparse.pad_problem(sprob, 4) is sprob
    data = _port(d, "pg.", convert.pose_graph_data_from_numpy)
    assert dist_pose_graph.pad_edges(data, 5) is data
    sim3 = _port(d, "sim3.", convert.sim3_graph_data_from_numpy)
    assert dist_pose_graph.pad_sim3_edges(sim3, 13) is sim3

    from mvslam_tpu.parallel import dist_ba as jdba

    odd = jprob._replace(points0=jprob.points0[:250],
                         obs=jprob.obs[:, :250],
                         obs_mask=jprob.obs_mask[:, :250],
                         obs_weight=jprob.obs_weight[:, :250],
                         point_prior=jprob.point_prior[:250],
                         point_prior_info=jprob.point_prior_info[:250])
    got = dist_ba.pad_problem(convert.ba_problem_from_numpy(
        convert.problem_to_numpy(odd), device="cpu"), 8)
    for pairs in (
            (got, jdba.pad_problem(odd, 8)),
            (dist_pose_graph.pad_edges(data, 4),
             jdpg.pad_edges(jpg_data, 4)),
            (dist_pose_graph.pad_sim3_edges(sim3, 8),
             jdpg.pad_sim3_edges(sim3_jax_data(w.subdict(d, "sim3.")), 8))):
        a, b = (convert.problem_to_numpy(x) for x in pairs)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    padded = pg.pose_graph_optimize(dist_pose_graph.pad_edges(data, 4))
    plain = pg.pose_graph_optimize(data)
    np.testing.assert_allclose(padded.poses.t, plain.poses.t, atol=1e-12)
