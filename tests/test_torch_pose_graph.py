"""The PyTorch port's SE3 pose graph against the JAX package's.

A noisy 12-node ring with one loop edge (plus one masked node and one
masked edge, so the masks are exercised), drawn with numpy from a seed and
handed to both packages as the same arrays: residuals and their autodiff
Jacobians, cost, normal equations, and the LM optimum with its iteration
count. Then the host-side ``Graph`` / ``GraphOptimizer`` wrapper on the same
calls, and the Lie maps under forward-mode autodiff at the identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.backend import graph as jgraph
from mvslam_tpu.backend import pose_graph as jpg
from mvslam_tpu.math import lie as jlie
from mvslam_tpu_torch import convert
from mvslam_tpu_torch.backend import graph as tgraph
from mvslam_tpu_torch.backend import pose_graph as tpg
from mvslam_tpu_torch.math import lie as tlie

#: one evaluation, relative to the compared array's largest magnitude
EVAL_RTOL = {"float32": 1e-5, "float64": 1e-10}
#: optimized poses, absolute (ring radius 3). At the optimum the last LM
#: step moves the poses by ~1e-8 (float64) while it changes the cost by
#: less than the cost's rounding, so whether it is accepted is decided by the
#: last bit: the two packages agree through the step before it (3e-15) and
#: differ by 1.1e-8 after it
OPT_ATOL = {"float32": 2e-4, "float64": 1e-7}
N_RING = 12


def ring_arrays(dtype: str, seed: int = 11) -> dict:
    """The ring as a ``problem_to_numpy`` dict: node k at angle 2 pi k / 12 on
    a radius-3 circle heading along the tangent; 11 odometry edges and the
    closing edge 11 -> 0 with noisy measurements; noisy initial poses; node 0
    anchored; node 12 and edge 12 are masked padding."""
    rng = np.random.default_rng(seed)
    N, E = N_RING + 1, N_RING + 1
    th = 2 * np.pi * np.arange(N_RING) / N_RING
    xi = np.stack([3 * np.cos(th), 3 * np.sin(th), 0.1 * np.sin(2 * th),
                   0 * th, 0 * th, th + np.pi / 2], 1)
    true = tlie.SE3.exp(torch.tensor(xi))
    noisy = true.compose(tlie.SE3.exp(torch.tensor(
        0.05 * rng.standard_normal((N_RING, 6)))))
    src = np.arange(N_RING)
    dst = (src + 1) % N_RING
    rel = tlie.SE3(true.R[src], true.t[src]).inverse().compose(
        tlie.SE3(true.R[dst], true.t[dst]))
    rel = rel.compose(tlie.SE3.exp(torch.tensor(
        0.01 * rng.standard_normal((N_RING, 6)))))

    def pad(x, fill):
        return np.concatenate([x.numpy(), fill[None]]).astype(dtype)

    A = rng.standard_normal((E, 6, 6))
    info = 50.0 * np.eye(6) + np.einsum("eij,ekj->eik", A, A)
    prior_info = np.zeros((N, 6, 6))
    prior_info[0] = np.eye(6) / tpg.ORIGIN_STDDEV ** 2
    poses_R, poses_t = pad(noisy.R, np.eye(3)), pad(noisy.t, np.zeros(3))
    return {
        "poses.R": poses_R, "poses.t": poses_t,
        "node_mask": np.arange(N) < N_RING,
        "edge_src": np.append(src, 0), "edge_dst": np.append(dst, 0),
        "edge_rel.R": pad(rel.R, np.eye(3)),
        "edge_rel.t": pad(rel.t, np.zeros(3)),
        "edge_info": info.astype(dtype), "edge_mask": np.arange(E) < N_RING,
        "prior_pose.R": poses_R, "prior_pose.t": poses_t,
        "prior_info": prior_info.astype(dtype),
    }


def jax_data(d: dict) -> jpg.PoseGraphData:
    def se3(name):
        return jlie.SE3(jnp.asarray(d[f"{name}.R"]),
                        jnp.asarray(d[f"{name}.t"]))

    return jpg.PoseGraphData(
        se3("poses"), jnp.asarray(d["node_mask"]),
        jnp.asarray(d["edge_src"], jnp.int32),
        jnp.asarray(d["edge_dst"], jnp.int32), se3("edge_rel"),
        jnp.asarray(d["edge_info"]), jnp.asarray(d["edge_mask"]),
        se3("prior_pose"), jnp.asarray(d["prior_info"]))


@pytest.fixture(scope="module", params=["float32", "float64"])
def ring(request):
    d = ring_arrays(request.param)
    return (request.param,
            convert.pose_graph_data_from_numpy(d, device="cpu"), jax_data(d))


def _close(got, want, rtol, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def test_data_keeps_its_dtype(ring):
    name, td, _ = ring
    assert td.poses.t.dtype == getattr(torch, name)
    assert td.edge_src.dtype == torch.int64
    assert td.edge_mask.dtype == torch.bool


def test_residuals_and_jacobians_match(ring):
    name, td, jd = ring
    got = tpg._edge_residuals_and_jacobians(td)
    want = jpg._edge_residuals_and_jacobians(jd)
    for g, w, what in zip(got, want, ("r", "Js", "Jd")):
        assert g.dtype == getattr(torch, name), what
        _close(g, w, EVAL_RTOL[name], what)
    np.testing.assert_array_equal(tpg._edge_residuals(td).numpy(),
                                  got[0].numpy())


def test_cost_matches(ring):
    name, td, jd = ring
    want = float(jpg.pose_graph_cost(jd))
    assert abs(float(tpg.pose_graph_cost(td)) - want) <= (
        10 * EVAL_RTOL[name] * want)


def test_normal_equations_match(ring):
    name, td, jd = ring
    (tH, tb), (jH, jb) = tpg._normal_equations(td), jpg._normal_equations(jd)
    _close(tH, jH, EVAL_RTOL[name], "H")
    # b sums products of the 1e8 anchor information with residuals
    _close(tb, jb, 10 * EVAL_RTOL[name], "b")
    # the masked node is pinned with identity, nothing else touches it
    np.testing.assert_array_equal(tH[N_RING, N_RING].numpy(), np.eye(6))
    assert float(tb[N_RING].abs().max()) == 0.0


def test_optimum_matches(ring):
    name, td, jd = ring
    got, want = tpg.pose_graph_optimize(td), jpg.pose_graph_optimize(jd)
    assert float(got.error) < 0.05 * float(tpg.pose_graph_cost(td))
    np.testing.assert_allclose(got.poses.t.numpy(), np.asarray(want.poses.t),
                               rtol=0, atol=OPT_ATOL[name])
    np.testing.assert_allclose(got.poses.R.numpy(), np.asarray(want.poses.R),
                               rtol=0, atol=OPT_ATOL[name])
    assert bool(got.converged) == bool(want.converged) is True
    if name == "float64":
        assert int(got.iterations) == int(want.iterations)
        assert abs(float(got.error) - float(want.error)) <= 1e-9 * (
            1.0 + float(want.error))
    # the masked node did not move
    np.testing.assert_array_equal(got.poses.t[N_RING].numpy(), np.zeros(3))


# ---------------------------------------------------------------------------
# the host-side wrapper, on the same calls
# ---------------------------------------------------------------------------


def _both_graphs(rng, n=6):
    """One random chain with a closing edge, built through both wrappers."""
    tg_ = tgraph.Graph(device="cpu")
    jg_ = jgraph.Graph()
    poses = [np.zeros(6)]
    for k in range(1, n):
        poses.append(poses[-1] + np.array([1.0, 0.2, 0.0, 0.0, 0.0, 0.3]))
    tids, jids = [tg_.origin_id], [jg_.origin_id]
    for xi in poses[1:]:
        guess = xi + 0.05 * rng.standard_normal(6)
        tids.append(tg_.add_pose_node(tlie.SE3.exp(torch.tensor(guess))))
        jids.append(jg_.add_pose_node(jlie.SE3.exp(jnp.asarray(guess))))
    pairs = [(k, k + 1) for k in range(n - 1)] + [(n - 1, 0)]
    for s, d in pairs:
        true_rel = tlie.SE3.exp(torch.tensor(poses[s])).inverse().compose(
            tlie.SE3.exp(torch.tensor(poses[d])))
        xi = true_rel.log().numpy() + 0.01 * rng.standard_normal(6)
        cov = np.diag(rng.uniform(0.01, 0.04, 6))
        te = tg_.add_transformation_edge(
            s, d, tlie.SE3.exp(torch.tensor(xi)), cov)
        je = jg_.add_transformation_edge(
            s, d, jlie.SE3.exp(jnp.asarray(xi)), cov)
        assert te == je
    assert tids == jids
    return tg_, jg_


def _assert_same_values(tg_, jg_, atol=1e-12):
    assert tg_.node_count() == jg_.node_count()
    assert tg_.edge_count() == jg_.edge_count()
    tv, jv = tg_.get_all_pose_node_values(), jg_.get_all_pose_node_values()
    np.testing.assert_allclose(tv.matrix().numpy(), np.asarray(jv.matrix()),
                               rtol=0, atol=atol)


def test_graph_wrapper_matches_on_the_same_calls(rng):
    tg_, jg_ = _both_graphs(rng)
    _assert_same_values(tg_, jg_)
    assert tg_.adjacent_edges(0) == jg_.adjacent_edges(0)
    ts, td_, trel = tg_.get_edge(2)
    js, jd_, jrel = jg_.get_edge(2)
    assert (ts, td_) == (js, jd_)
    np.testing.assert_allclose(trel.matrix().numpy(),
                               np.asarray(jrel.matrix()), atol=1e-12)
    np.testing.assert_allclose(
        tg_.get_pose_node_value(3).t.numpy(),
        np.asarray(jg_.get_pose_node_value(3).t), atol=1e-12)
    # to_data: the port does not pad (there is no compiled shape to keep);
    # its tensors are the live prefix of the JAX package's padded ones
    t_data, j_data = tg_.to_data(), jg_.to_data()
    n, e = tg_.node_count(), tg_.edge_count()
    assert t_data.poses.t.shape == (n, 3) and t_data.edge_src.shape == (e,)
    assert t_data.poses.t.dtype == torch.float64
    for got, want in zip(convert.problem_to_numpy(t_data).items(),
                         convert.problem_to_numpy(j_data).values()):
        key, got = got
        k = n if key.split(".")[0] in ("poses", "node_mask", "prior_pose",
                                       "prior_info") else e
        np.testing.assert_allclose(got, want[:k], rtol=0, atol=1e-12,
                                   err_msg=key)
    # an edgeless graph still gives the solver one (masked) edge slot
    lone = tgraph.Graph(device="cpu").to_data()
    assert lone.edge_src.shape == (1,) and not bool(lone.edge_mask.any())
    assert float(tpg.pose_graph_cost(lone)) == 0.0


def test_graph_optimizer_matches_and_copies_until_update(rng):
    tg_, jg_ = _both_graphs(rng)
    before = tg_.get_all_pose_node_values().t.numpy().copy()
    topt, jopt = tgraph.GraphOptimizer(tg_), jgraph.GraphOptimizer(jg_)
    with pytest.raises(RuntimeError):
        topt.get_optimized_pose(0)
    te, je = topt.optimize(), jopt.optimize()
    assert abs(te - je) <= 1e-9 * (1.0 + je)
    assert int(topt.result.iterations) == int(jopt.result.iterations)
    assert bool(topt.result.converged) == bool(jopt.result.converged)
    np.testing.assert_allclose(
        topt.get_optimized_pose(4).t.numpy(),
        np.asarray(jopt.get_optimized_pose(4).t), atol=OPT_ATOL["float64"])
    # the graph keeps its values until update_graph writes them back
    np.testing.assert_array_equal(
        tg_.get_all_pose_node_values().t.numpy(), before)
    topt.update_graph()
    jopt.update_graph()
    _assert_same_values(tg_, jg_, atol=OPT_ATOL["float64"])
    assert np.abs(tg_.get_all_pose_node_values().t.numpy() - before).max() > 0


def test_merge_from_set_anchor_and_unknown_nodes(rng):
    tg_, jg_ = _both_graphs(rng)
    t2, j2 = _both_graphs(rng, n=4)
    xi = np.array([0.5, -1.0, 0.2, 0.1, -0.2, 0.3])
    tmap = tg_.merge_from(t2, tlie.SE3.exp(torch.tensor(xi)))
    jmap = jg_.merge_from(j2, jlie.SE3.exp(jnp.asarray(xi)))
    assert tmap == jmap
    _assert_same_values(tg_, jg_)
    tg_.set_anchor(tmap[0])
    jg_.set_anchor(jmap[0])
    tp = tg_.to_data().prior_info.numpy()
    np.testing.assert_allclose(
        tp, np.asarray(jg_.to_data().prior_info)[:tg_.node_count()],
        rtol=1e-12)
    assert tp[tmap[0], 0, 0] == pytest.approx(1e8) and tp[1].max() == 0.0
    with pytest.raises(KeyError):
        tg_.add_transformation_edge(0, 99, tlie.SE3.identity())
    with pytest.raises(KeyError):
        tg_.set_anchor(99)


def test_graph_defaults_to_float64_on_the_card():
    import inspect

    sig = inspect.signature(tgraph.Graph.__init__).parameters
    assert sig["device"].default == "cuda"
    assert sig["dtype"].default == torch.float64


# ---------------------------------------------------------------------------
# Lie maps: the matrix forms, and forward-mode autodiff at the identity
# ---------------------------------------------------------------------------


def test_se3_matrix_and_from_matrix_match(rng):
    xi = rng.standard_normal((5, 6))
    tT, jT = tlie.SE3.exp(torch.tensor(xi)), jlie.SE3.exp(jnp.asarray(xi))
    M = tT.matrix()
    assert M.shape == (5, 4, 4)
    np.testing.assert_allclose(M.numpy(), np.asarray(jT.matrix()),
                               atol=1e-14)
    back = tlie.SE3.from_matrix(M)
    assert torch.equal(back.R, tT.R) and torch.equal(back.t, tT.t)
    assert tlie.SE3.exp(torch.tensor(xi[0])).matrix().shape == (4, 4)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fn", ["so3_log", "se3_log", "se3_exp",
                                "exp_log_round_trip"])
def test_lie_maps_under_jacfwd_at_the_identity(fn, dtype):
    """The Taylor branches are selected by ``where``; the untaken branch
    (``sqrt`` / ``acos`` at 0) must not leak NaN tangents, and the
    derivative at zero tangent must equal the JAX package's."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tfun, jfun, k = {
        "so3_log": (lambda w: tlie.so3_log(tlie.so3_exp(w)),
                    lambda w: jlie.so3_log(jlie.so3_exp(w)), 3),
        "se3_log": (lambda x: tlie.SE3.exp(x).log(),
                    lambda x: jlie.SE3.exp(x).log(), 6),
        "se3_exp": (lambda x: tlie.SE3.exp(x).matrix3x4(),
                    lambda x: jlie.SE3.exp(x).matrix3x4(), 6),
        "exp_log_round_trip": (
            lambda x: tlie.SE3.exp(tlie.SE3.exp(x).log()).t,
            lambda x: jlie.SE3.exp(jlie.SE3.exp(x).log()).t, 6),
    }[fn]
    # a leading axis of one, as the graph residuals call these maps
    got = torch.func.jacfwd(lambda x: tfun(x[None])[0])(
        torch.zeros(k, dtype=tdt))
    want = np.asarray(jax.jacfwd(jfun)(jnp.zeros(k, jdt)))
    assert got.dtype == tdt
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 if dtype == "float32" else 1e-14)
