"""Which problems ``ops/ba.ba_solve`` hands to the two-frame BA kernel
(``ops/ba_cuda.takes``), decided without a card: a problem on a CUDA
device, in float32, with two poses and 1 to ``CAPACITY`` points, solved
without a process group and without covariances; every other problem runs
the plain body. On the CPU ``ba_solve`` is the plain body bit for bit and
never reaches the kernel's wrapper, which refuses CPU tensors; where the
rule holds, ``ba_solve`` returns what the wrapper gives with zero
covariances."""

import pytest
import torch

from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops import ba, ba_cuda

CUDA, CPU = torch.device("cuda", 0), torch.device("cpu")
F32, F64 = torch.float32, torch.float64
#: (device, dtype, frames, points, grouped, covariance) -> kernel
SCOPE = {
    "tracker": ((CUDA, F32, 2, 512, False, False), True),
    "kitti": ((CUDA, F32, 2, 2048, False, False), True),
    "one_point": ((CUDA, F32, 2, 1, False, False), True),
    "cpu": ((CPU, F32, 2, 512, False, False), False),
    "float64": ((CUDA, F64, 2, 512, False, False), False),
    "one_frame": ((CUDA, F32, 1, 512, False, False), False),
    "three_frames": ((CUDA, F32, 3, 512, False, False), False),
    "group": ((CUDA, F32, 2, 512, True, False), False),
    "covariance": ((CUDA, F32, 2, 512, False, True), False),
    "over_capacity": ((CUDA, F32, 2, ba_cuda.CAPACITY + 1, False, False),
                      False),
    "no_points": ((CUDA, F32, 2, 0, False, False), False),
}


@pytest.mark.parametrize("name", sorted(SCOPE))
def test_scope_rule(name):
    args, kernel = SCOPE[name]
    assert ba_cuda.takes(*args) is kernel


def _problem(dtype=F32, P=24, seed=0) -> ba.BAProblem:
    g = torch.Generator().manual_seed(seed)
    X = torch.cat([torch.rand((P, 2), generator=g, dtype=dtype) * 2 - 1,
                   torch.rand((P, 1), generator=g, dtype=dtype) * 4 + 4], 1)
    R = torch.eye(3, dtype=dtype).expand(2, 3, 3).clone()
    t = torch.tensor([[0.0, 0.0, 0.0], [0.2, 0.0, 0.0]], dtype=dtype)
    obs = torch.stack([(X - t[f])[:, :2] / (X - t[f])[:, 2:] for f in range(2)])
    obs = obs + 1e-3 * torch.randn(obs.shape, generator=g, dtype=dtype)
    info = torch.zeros((2, 6, 6), dtype=dtype)
    info[0] = 1e10 * torch.eye(6, dtype=dtype)
    poses = SE3(R, t + 0.01)
    return ba.BAProblem.create(
        poses, X + 0.02, obs, torch.ones((2, P), dtype=torch.bool),
        pose_prior=poses, pose_prior_info=info)


PARAMS = ba.BAParams(max_iterations=10, compute_covariance=False,
                     compute_point_info=True)


def _refuse(*args, **kwargs):
    raise AssertionError("the kernel's wrapper was called")


def test_cpu_problem_runs_the_plain_body(monkeypatch):
    monkeypatch.setattr(ba_cuda, "two_frame_solve", _refuse)
    prob = _problem()
    got, want = ba.ba_solve(prob, PARAMS), ba.ba_solve_plain(prob, PARAMS)
    for a, b in zip(got, want):
        a, b = (a, b) if isinstance(a, torch.Tensor) else (a.t, b.t)
        assert torch.equal(a, b)


def test_in_scope_result_is_the_wrapper_s_with_zero_covariances(monkeypatch):
    """With the rule made to hold on the CPU, ``ba_solve`` returns the
    wrapper's seven outputs as a ``BAResult``."""
    plain = ba.ba_solve_plain(_problem(), PARAMS)

    def fake(prob, params):
        assert params is PARAMS and prob.points0.is_contiguous()
        return (plain.poses.R, plain.poses.t, plain.points, plain.error,
                plain.iterations, plain.converged, plain.point_information)

    monkeypatch.setattr(ba_cuda, "takes", lambda *args: True)
    monkeypatch.setattr(ba_cuda, "two_frame_solve", fake)
    res = ba.ba_solve(_problem(), PARAMS)
    assert res.poses.R is plain.poses.R and res.points is plain.points
    assert res.point_information is plain.point_information
    assert res.pose_covariance.shape == (2, 6, 6)
    assert res.point_covariance.shape == (24, 3, 3)
    assert not res.pose_covariance.any() and not res.point_covariance.any()


@pytest.mark.parametrize("what", ["cpu", "no_points", "over_capacity",
                                  "covariance"])
def test_wrapper_refuses_before_building(monkeypatch, what):
    """The wrapper raises on what the kernel does not take before it looks
    for nvcc; the launch count stays."""
    monkeypatch.setattr(ba_cuda, "load_library", _refuse)
    P = {"no_points": 0, "over_capacity": ba_cuda.CAPACITY + 1}.get(what, 8)
    prob = _problem(P=P)
    params = PARAMS._replace(compute_covariance=what == "covariance")
    n = ba_cuda.two_frame_solve.launches
    with pytest.raises(ValueError):
        ba_cuda.two_frame_solve(prob, params)
    assert ba_cuda.two_frame_solve.launches == n


def test_float64_cpu_solve_is_the_plain_body(monkeypatch):
    monkeypatch.setattr(ba_cuda, "two_frame_solve", _refuse)
    prob = _problem(F64)
    got, want = ba.ba_solve(prob, PARAMS), ba.ba_solve_plain(prob, PARAMS)
    assert torch.equal(got.points, want.points)
    assert torch.equal(got.poses.t, want.poses.t)
