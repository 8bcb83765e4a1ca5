"""The PyTorch port's Sim3 pose graph against the JAX package's.

The ``Sim3`` algebra on random elements, then a noisy, scale-drifted
12-node ring with one (scale-measuring) loop edge, one outlier edge for the
Huber weights and one masked node and edge, drawn with numpy from a seed
and handed to both packages as the same arrays: residuals and their autodiff
Jacobians, cost, normal equations, and the LM optimum with its iteration
count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mvslam_tpu.backend import sim3_graph as jsg
from mvslam_tpu_torch import convert
from mvslam_tpu_torch.backend import sim3_graph as tsg
from mvslam_tpu_torch.backend.pose_graph import ORIGIN_STDDEV
from mvslam_tpu_torch.math import lie as tlie

#: one evaluation, relative to the compared array's largest magnitude
EVAL_RTOL = {"float32": 1e-5, "float64": 1e-10}
#: optimized poses, absolute (ring radius 3); float64 for the reason given
#: in tests/test_torch_pose_graph.py (the last LM step is below the cost's
#: rounding)
OPT_ATOL = {"float32": 5e-4, "float64": 1e-7}
N_RING = 12


def _sim3_arrays(rng, n, dtype="float64"):
    s = np.exp(0.2 * rng.standard_normal(n)).astype(dtype)
    T = tlie.SE3.exp(torch.tensor(rng.standard_normal((n, 6))))
    return s, T.R.numpy().astype(dtype), T.t.numpy().astype(dtype)


def _pair(arrs):
    return (tsg.Sim3(*(torch.from_numpy(a) for a in arrs)),
            jsg.Sim3(*(jnp.asarray(a) for a in arrs)))


def _assert_sim3_close(t: tsg.Sim3, j: jsg.Sim3, atol):
    for a, b, what in zip(t, j, "sRt"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=atol, err_msg=what)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("float64", 1e-13)])
def test_sim3_algebra_matches_and_round_trips(rng, dtype, atol):
    (tA, jA), (tB, jB) = (_pair(_sim3_arrays(rng, 7, dtype)) for _ in "ab")
    x = rng.standard_normal((7, 3)).astype(dtype)
    delta = (0.3 * rng.standard_normal((7, 7))).astype(dtype)
    _assert_sim3_close(tA.compose(tB), jA.compose(jB), atol)
    _assert_sim3_close(tA.inverse(), jA.inverse(), atol)
    _assert_sim3_close(tA.retract(torch.from_numpy(delta)),
                       jA.retract(jnp.asarray(delta)), atol)
    np.testing.assert_allclose(tA.apply(torch.from_numpy(x)).numpy(),
                               np.asarray(jA.apply(jnp.asarray(x))),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(tA.chart_log().numpy(),
                               np.asarray(jA.chart_log()), rtol=0, atol=atol)
    # round trips: A . A^-1 = identity; A^-1 (A x) = x; the chart of a
    # retraction of the identity is the retraction's argument
    ident = tsg.Sim3.identity((7,), dtype=getattr(torch, dtype))
    for a, b in zip(tA.compose(tA.inverse()), ident):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=10 * atol)
    np.testing.assert_allclose(
        tA.inverse().apply(tA.apply(torch.from_numpy(x))).numpy(), x,
        rtol=0, atol=20 * atol)
    np.testing.assert_allclose(
        ident.retract(torch.from_numpy(delta)).chart_log().numpy(), delta,
        rtol=0, atol=atol)
    assert float(ident.chart_log().abs().max()) == 0.0


def ring_arrays(dtype: str, seed: int = 5) -> dict:
    """A radius-3 ring whose odometry shrinks by 1% per step (scale drift);
    the closing edge 11 -> 0 measures the accumulated scale; edge 4 -> 5 is
    an outlier; node 12 and edge 12 are masked padding."""
    rng = np.random.default_rng(seed)
    N, E = N_RING + 1, N_RING + 1
    th = 2 * np.pi * np.arange(N_RING) / N_RING
    xi = np.stack([3 * np.cos(th), 3 * np.sin(th), 0.1 * np.sin(2 * th),
                   0 * th, 0 * th, th + np.pi / 2], 1)
    true = tlie.SE3.exp(torch.tensor(xi))
    noisy = true.compose(tlie.SE3.exp(torch.tensor(
        0.03 * rng.standard_normal((N_RING, 6)))))
    src = np.arange(N_RING)
    dst = (src + 1) % N_RING
    rel = tlie.SE3(true.R[src], true.t[src]).inverse().compose(
        tlie.SE3(true.R[dst], true.t[dst]))
    rel = rel.compose(tlie.SE3.exp(torch.tensor(
        0.01 * rng.standard_normal((N_RING, 6)))))
    rel_t = rel.t.numpy() * (0.99 ** np.arange(N_RING))[:, None]
    rel_t[4] += np.array([0.4, -0.3, 0.2])               # the outlier
    s_rel = np.ones(N_RING)
    s_rel[-1] = 0.99 ** -11

    def pad(x, fill):
        return np.concatenate([np.asarray(x), np.asarray(fill)[None]]
                              ).astype(dtype)

    sig = np.concatenate([np.full(3, 0.05), np.full(3, 0.03), [0.02]])
    info = np.tile(np.diag(1.0 / sig ** 2), (E, 1, 1))
    prior_info = np.zeros((N, 7, 7))
    prior_info[0] = np.eye(7) / ORIGIN_STDDEV ** 2
    poses = {"s": pad(np.exp(0.02 * rng.standard_normal(N_RING)), 1.0),
             "R": pad(noisy.R.numpy(), np.eye(3)),
             "t": pad(noisy.t.numpy(), np.zeros(3))}
    d = {"node_mask": np.arange(N) < N_RING,
         "edge_src": np.append(src, 0), "edge_dst": np.append(dst, 0),
         "edge_rel.s": pad(s_rel, 1.0),
         "edge_rel.R": pad(rel.R.numpy(), np.eye(3)),
         "edge_rel.t": pad(rel_t, np.zeros(3)),
         "edge_info": info.astype(dtype), "edge_mask": np.arange(E) < N_RING,
         "prior_info": prior_info.astype(dtype)}
    for k, v in poses.items():
        d[f"poses.{k}"] = v
        d[f"prior_pose.{k}"] = v
    return d


def jax_data(d: dict) -> jsg.Sim3GraphData:
    def sim3(name):
        return jsg.Sim3(*(jnp.asarray(d[f"{name}.{k}"]) for k in "sRt"))

    return jsg.Sim3GraphData(
        sim3("poses"), jnp.asarray(d["node_mask"]),
        jnp.asarray(d["edge_src"], jnp.int32),
        jnp.asarray(d["edge_dst"], jnp.int32), sim3("edge_rel"),
        jnp.asarray(d["edge_info"]), jnp.asarray(d["edge_mask"]),
        sim3("prior_pose"), jnp.asarray(d["prior_info"]))


@pytest.fixture(scope="module", params=["float32", "float64"])
def ring(request):
    d = ring_arrays(request.param)
    return (request.param,
            convert.sim3_graph_data_from_numpy(d, device="cpu"), jax_data(d))


def _close(got, want, rtol, what=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rtol * scale,
                               err_msg=what)


def test_residuals_and_jacobians_match(ring):
    name, td, jd = ring
    got = tsg._edge_residuals_and_jacobians(td)
    want = jsg._edge_residuals_and_jacobians(jd)
    for g, w, what in zip(got, want, ("r", "Js", "Jd")):
        assert g.dtype == getattr(torch, name), what
        _close(g, w, EVAL_RTOL[name], what)
    assert got[1].shape == (N_RING + 1, 7, 7)
    np.testing.assert_array_equal(tsg._edge_residuals(td).numpy(),
                                  got[0].numpy())


@pytest.mark.parametrize("huber", [None, 3.0])
def test_cost_and_huber_weights_match(ring, huber):
    name, td, jd = ring
    want = float(jsg.sim3_graph_cost(jd, None, huber))
    got = float(tsg.sim3_graph_cost(td, huber))
    assert abs(got - want) <= 10 * EVAL_RTOL[name] * want
    e2 = np.array([0.0, 1.0, 8.9, 9.1, 400.0]).astype(name)
    for g, w in zip(tsg._huber_rho_and_weight(torch.from_numpy(e2), huber),
                    jsg._huber_rho_and_weight(jnp.asarray(e2), huber)):
        _close(g, w, EVAL_RTOL[name])


def test_the_outlier_is_downweighted(ring):
    _, td, _ = ring
    r = tsg._edge_residuals(td)
    e2 = torch.einsum("ei,eij,ej->e", r, td.edge_info, r)
    _, w = tsg._huber_rho_and_weight(e2, 3.0)
    assert int(torch.argmin(w[:N_RING])) == 4 and float(w[4]) < 0.5


def test_normal_equations_match(ring):
    name, td, jd = ring
    for huber in (None, 3.0):
        tH, tb = tsg._normal_equations(td, huber)
        jH, jb = jsg._normal_equations(jd, None, huber)
        _close(tH, jH, EVAL_RTOL[name], "H")
        _close(tb, jb, 10 * EVAL_RTOL[name], "b")
    np.testing.assert_array_equal(tH[N_RING, N_RING].numpy(), np.eye(7))


def test_optimum_matches(ring):
    name, td, jd = ring
    got, want = tsg.sim3_graph_optimize(td), jsg.sim3_graph_optimize(jd)
    assert float(got.error) < 0.5 * float(tsg.sim3_graph_cost(td, 3.0))
    _assert_sim3_close(got.poses, want.poses, OPT_ATOL[name])
    assert bool(got.converged) == bool(want.converged) is True
    if name == "float64":
        assert int(got.iterations) == int(want.iterations)
        assert abs(float(got.error) - float(want.error)) <= 1e-9 * (
            1.0 + float(want.error))
    # the graph absorbed the drift as node scales: they fall around the ring
    s = got.poses.s[:N_RING]
    assert float(s[0]) == pytest.approx(1.0, abs=1e-3)
    assert float(s[-1]) < 0.95
    assert float(got.poses.s[N_RING]) == 1.0            # masked: untouched
