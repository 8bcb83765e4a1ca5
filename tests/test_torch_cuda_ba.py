"""The two-frame BA kernel (``ops/ba_cuda``, ``csrc/ba_two_frame.cu``) on
the card, against ``ops/ba.ba_solve_plain``: the plain body on the card in
float32 and on the CPU in float64, on problems made with numpy from fixed
seeds (the tracker's 512 and 2,048 points and a ragged 300; Huber off and
at the KITTI deployment's sqrt(5.991); masked observations; zero and full
point priors; the tracker's 1e10 anchor and ``sfm_refine``'s
``scale_only`` gauge; 10 and 15 iterations), each case over 64 seeds
and held by its spread over them as well as seed by seed where the
float32 solves settle, one LM step against float64's, a system that is not
positive definite (the jittered re-solve, and the NaN fill where that
fails too), the same bits from two calls and from a CUDA-graph replay,
one launch a solve, and the problems ``ba_solve`` keeps on the plain body.
Every test needs a CUDA card and skips without one; this file imports no
JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_ba.py
"""

import functools
import math
import statistics
from typing import NamedTuple

import numpy as np
import pytest
import torch

from mvslam_tpu_torch.math.lie import SE3
from mvslam_tpu_torch.ops import ba, ba_cuda, sfm

pytestmark = pytest.mark.cuda

FOCAL = 718.856
#: ORB-SLAM2's deltaMono = sqrt(5.991)
HUBER = math.sqrt(5.991)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


class Case(NamedTuple):
    points: int
    huber: bool = False
    masked: bool = False
    point_prior: str = "zero"     # "zero", "map" (the tracker's), "full"
    gauge: str = "anchor"         # the tracker's 1e10 anchor, "scale_only"
    iterations: int = 10
    #: stops short of the float64 solve at ``iterations``: 2,000 or more
    #: points with gross outliers under Huber
    short: bool = False


CASES = {
    "tracker_512": Case(512, masked=True, point_prior="map"),
    "kitti_2048_huber": Case(2048, huber=True, masked=True,
                             point_prior="map", short=True),
    "ragged_300_huber": Case(300, huber=True, point_prior="full"),
    "full_prior_512_15it": Case(512, point_prior="full", iterations=15),
    "full_prior_2048_masked": Case(2048, masked=True, point_prior="full"),
    "scale_only_500": Case(500, gauge="scale_only"),
    "scale_only_2000_huber": Case(2000, huber=True, gauge="scale_only",
                                  short=True),
    "map_prior_2048_15it": Case(2048, masked=True, point_prior="map",
                                iterations=15),
}
#: the cases in which both float32 solves settle at the float64 solve
#: within their iterations: the tracker's anchor and no gross outliers
SETTLED = sorted(n for n, c in CASES.items()
                 if c.gauge == "anchor" and not c.short)


def _rot(w) -> np.ndarray:
    return SE3.exp(torch.tensor(np.r_[0.0, 0.0, 0.0, w])).R.numpy()


def make_problem(case: Case, seed: int, dtype=torch.float64,
                 device="cpu") -> ba.BAProblem:
    """Two poses 0.12 apart and ``case.points`` points 5-20 units ahead,
    observed on the ideal plane with 0.25-1 px of noise (weights
    focal / sigma px); with ``huber`` a tenth of the second frame's
    observations moved by 10-30 px; with ``masked`` a twentieth of the
    observations of the points with a prior masked (a point without one
    stays seen twice, as the tracker's fresh points are: seen once it
    would be free along its ray). The start is the truth perturbed. Priors: the
    start's first pose pinned at 1e10 (``anchor``) or ``sfm_refine``'s
    ``scale_only`` gauge (the first pose at 1e10, the second's translation
    along itself); the start's points at 0.05 units, on the first three
    quarters (``map``, the tracker's map points) or on every point with a
    random positive definite information (``full``), or none."""
    rng = np.random.default_rng(seed)
    P = case.points
    R = np.stack([_rot(rng.normal(0, 0.01, 3)), _rot(rng.normal(0, 0.01, 3))])
    t = np.stack([np.zeros(3), np.array([0.12, 0.01, 0.02])])
    if case.gauge == "scale_only":
        R[0], t[0] = np.eye(3), np.zeros(3)
    X = np.c_[rng.uniform(-4, 4, P), rng.uniform(-1.5, 1.5, P),
              rng.uniform(5, 20, P)]
    sig_px = rng.uniform(0.25, 1.0, (2, P))
    obs = np.zeros((2, P, 2))
    for f in range(2):
        Xc = (X - t[f]) @ R[f]
        obs[f] = (Xc[:, :2] / Xc[:, 2:]
                  + rng.normal(0, 1, (P, 2)) * sig_px[f, :, None] / FOCAL)
    if case.huber:
        bad = rng.random(P) < 0.1
        n_bad = int(bad.sum())
        obs[1, bad] += (rng.uniform(10, 30, (n_bad, 2))
                        * rng.choice([-1, 1], (n_bad, 2)) / FOCAL)
    mask = np.ones((2, P), bool)
    if case.masked:
        mask = rng.random((2, P)) > 0.05
    R0, t0 = R.copy(), t.copy()
    R0[1] = R[1] @ _rot(rng.normal(0, 0.002, 3))
    t0[1] = t[1] + rng.normal(0, 0.01, 3)
    X0 = X + rng.normal(0, 0.05, X.shape)
    info = np.zeros((P, 3, 3))
    if case.point_prior == "map":
        info[: 3 * P // 4] = np.eye(3) / 0.05 ** 2
    elif case.point_prior == "full":
        A = rng.normal(0, 1, (P, 3, 3))
        info = (A @ A.transpose(0, 2, 1) + np.eye(3)) * 100.0
    mask[:, info[:, 0, 0] == 0] = True
    pose_info = np.zeros((2, 6, 6))
    if case.gauge == "anchor":
        pose_info[0] = 1e10 * np.eye(6)
    else:
        anchor = 1.0 / sfm.ANCHOR_STDDEV ** 2
        u = R0[1].T @ (t0[1] / np.linalg.norm(t0[1]))
        pose_info[0] = anchor * np.eye(6)
        pose_info[1, :3, :3] = anchor * np.outer(u, u)

    def T(a):
        return torch.tensor(a, dtype=dtype, device=device)

    poses0 = SE3(T(R0), T(t0))
    return ba.BAProblem.create(
        poses0, T(X0), T(obs), torch.tensor(mask, device=device),
        T(FOCAL / sig_px), pose_prior=poses0, pose_prior_info=T(pose_info),
        point_prior=T(X0), point_prior_info=T(info))


def params_of(case: Case, **kw) -> ba.BAParams:
    """The tracker's BA settings for ``case``."""
    return ba.BAParams(max_iterations=case.iterations,
                       compute_covariance=False, compute_point_info=True,
                       huber_delta=HUBER if case.huber else None, **kw)


class Gaps(NamedTuple):
    """How far a solve lies from a reference solve: the largest rotation
    angle between their poses (rad), the largest pose centre gap over the
    baseline, the largest point gap in the reference's sigmas
    (``sqrt(dX^T I dX)``, ``I`` the reference's point information: a
    point far along a ray it is loose along is near), and the cost's
    relative gap."""

    rot: float
    trans: float
    point: float
    cost: float


def gaps(res: ba.BAResult, ref: ba.BAResult) -> Gaps:
    f64 = torch.float64
    R, t, X = (x.detach().cpu().to(f64) for x in (res.poses.R, res.poses.t,
                                                  res.points))
    rR, rt, rX = (x.detach().cpu().to(f64) for x in (
        ref.poses.R, ref.poses.t, ref.points))
    rel = R.transpose(-1, -2) @ rR
    vee = torch.stack([rel[..., 2, 1] - rel[..., 1, 2],
                       rel[..., 0, 2] - rel[..., 2, 0],
                       rel[..., 1, 0] - rel[..., 0, 1]], -1)
    cos = (rel.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
    rot = float(torch.atan2(0.5 * torch.linalg.vector_norm(vee, dim=-1),
                            cos).max())
    base = float(torch.linalg.vector_norm(rt[1] - rt[0]))
    trans = float(torch.linalg.vector_norm(t - rt, dim=-1).max()) / base
    d = X - rX
    info = ref.point_information.detach().cpu().to(f64)
    point = float(torch.sqrt(torch.clamp(
        torch.einsum("pi,pij,pj->p", d, info, d), min=0)).max())
    cost = abs(float(res.error) / float(ref.error) - 1)
    return Gaps(rot, trans, point, cost)


#: The seeds each case is solved on. The kernel and the plain body sum in
#: different orders, so each stops at its own float32 neighbour of the
#: float64 solve, nearer on one seed and farther on the next: over these
#: 64 seeds (measured on an H100) the kernel lies farther than the plain
#: body on the card on 22-40 of them, gap by gap and case by case (the
#: one exception is below), and the plain body on the CPU, a third
#: summation order, spreads as much. One seed does not say which is
#: nearer.
SEEDS = tuple(range(1000, 1064))
#: Where the float32 solves settle (``SETTLED``), how far each may lie
#: from the float64 solve on every seed: a few times the largest the
#: plain float32 body reads over SEEDS in those cases on an H100 (1.1e-6
#: rad, 9.9e-5 of the baseline, 0.028 sigma, 1.2e-6 of the cost; the
#: kernel 1.1e-6, 9.8e-5, 0.031, 1.3e-6).
TOL_SETTLED = Gaps(4e-6, 4e-4, 0.1, 5e-6)
#: In every case, the median and the upper quartile over the seeds of
#: each of the kernel's gaps lie within ``SLACK`` times the plain body's
#: (float32 on the card, the same inputs) plus ``FLOOR``, a few float32
#: ulps of each gap (1e-6 rad, 1e-5 of the baseline, 1e-3 sigma, 1e-5 of
#: the cost). Measured on an H100: at most 1.21 times the plain body's
#: above the floor over SEEDS.
SLACK = 1.5
FLOOR = Gaps(1e-6, 1e-5, 1e-3, 1e-5)
#: Where the float32 solves do not settle, the float64 solve at the same
#: cap is no answer either. In ``scale_only`` (``sfm_refine``'s gauge: a
#: 1e10 prior on the first pose and on the second's translation along
#: itself, no point priors) float32 resolves the reduced system poorly:
#: one LM step from the same start lands ~2e-4 rad from float64's step
#: (median over 32 seeds, the kernel and the plain body alike), and a
#: solve may stall at a worse iterate for a few iterations (its cost more
#: than 1e-3 off float64's on 7 / 2 / 8 of 64 seeds: the kernel, the
#: plain body on the card, on the CPU). With a tenth of one frame's
#: observations 10-30 px off under Huber (``short``), 2,000 points are
#: still descending at 10 iterations, and most still are at 200 in
#: float64. There the kernel descends faster than the plain body (a lower
#: cost at 10 iterations on 27 of 32 seeds, at 20 on 30), so it leaves
#: the float64 solve at the cap farther in the poses (``kitti_2048_huber``:
#: median 2.5e-5 against 9.3e-6 rad) and nearer in the cost (0.0046
#: against 0.010); from the float64 solve at 200 iterations both lie as
#: far (median 3.4e-5 against 2.6e-5 rad, 0.0025 against 0.0024 of the
#: baseline, 0.030 against 0.031 of the cost). So the short cases are
#: measured from that solve, on the first 16 seeds.
OPTIMUM_ITERATIONS = 200
SHORT_SEEDS = SEEDS[:16]
#: One LM step from the same start, before the solves part: over the
#: first 32 seeds the kernel's median gaps from float64's step are at
#: most ``STEP_SLACK`` times the plain body's (measured on an H100:
#: 0.42-0.74 times in kitti_2048_huber, 0.63-0.99 in tracker_512,
#: 0.94-1.08 in scale_only_500). The kernel's arithmetic is no coarser
#: than the plain body's; where their solves part later, their paths do.
STEP_SLACK = 1.25
ONE_STEP_SEEDS = SEEDS[:32]
#: the jittered re-solve's problem: within ``JITTER_SLACK`` times the
#: plain float32 body's gaps plus ``FLOOR``
JITTER_SLACK = 4.0


def _within(g: Gaps, tol: Gaps) -> bool:
    return all(a <= b for a, b in zip(g, tol))


@functools.cache
def _sweep(name: str, iterations: int, ref_iterations: int,
           seeds: tuple) -> tuple[list[Gaps], list[Gaps]]:
    """The gaps of the kernel's solve and of the plain body's (float32 on
    the card, ``iterations`` each) from the plain body's float64 solve on
    the CPU (``ref_iterations``), a pair per seed of ``seeds``; the kernel
    launched once a solve."""
    case = CASES[name]
    params = params_of(case)._replace(max_iterations=iterations)
    ref_params = params._replace(max_iterations=ref_iterations)
    card_dev = torch.device("cuda", 0)
    k2s, plains = [], []
    for seed in seeds:
        ref = ba.ba_solve_plain(make_problem(case, seed), ref_params)
        card = make_problem(case, seed, dtype=torch.float32, device=card_dev)
        n = ba_cuda.two_frame_solve.launches
        k2 = ba.ba_solve(card, params)
        assert ba_cuda.two_frame_solve.launches == n + 1
        k2s.append(gaps(k2, ref))
        plains.append(gaps(ba.ba_solve_plain(card, params), ref))
    return k2s, plains


def _spread(gs: list[Gaps]) -> tuple[Gaps, Gaps]:
    """The median and the upper quartile of each gap over ``gs``."""
    cols = list(zip(*gs))
    return (Gaps(*(statistics.median(c) for c in cols)),
            Gaps(*(statistics.quantiles(c, n=4)[2] for c in cols)))


@pytest.mark.parametrize("name", SETTLED)
def test_kernel_lies_near_the_float64_solve(dev, name):
    n = CASES[name].iterations
    k2s, plains = _sweep(name, n, n, SEEDS)
    print(f"\n{name}: median, upper quartile: kernel {_spread(k2s)}, "
          f"plain float32 {_spread(plains)}")
    for seed, g_k2, g_plain in zip(SEEDS, k2s, plains):
        assert _within(g_k2, TOL_SETTLED), (seed, g_k2)
        assert _within(g_plain, TOL_SETTLED), (seed, g_plain)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_lies_where_the_plain_float32_body_lies(dev, name):
    case = CASES[name]
    if case.short:
        k2s, plains = _sweep(name, case.iterations, OPTIMUM_ITERATIONS,
                             SHORT_SEEDS)
    else:
        k2s, plains = _sweep(name, case.iterations, case.iterations, SEEDS)
    for got, want in zip(_spread(k2s), _spread(plains)):
        assert all(a <= SLACK * b + f for a, b, f in zip(got, want, FLOOR)), (
            name, got, want)


@pytest.mark.parametrize("name", ["kitti_2048_huber", "scale_only_500",
                                  "tracker_512"])
def test_one_step_lies_as_near_the_float64_step(dev, name):
    k2s, plains = _sweep(name, 1, 1, ONE_STEP_SEEDS)
    got, want = _spread(k2s)[0], _spread(plains)[0]
    print(f"\n{name}, one step: median kernel {got}, plain float32 {want}")
    assert all(a <= STEP_SLACK * b for a, b in zip(got, want)), (got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_result_has_the_plain_form(dev, name):
    case = CASES[name]
    k2 = ba.ba_solve(make_problem(case, SEEDS[0], dtype=torch.float32,
                                  device=dev), params_of(case))
    assert k2.poses.R.dtype == torch.float32 and k2.points.is_cuda
    assert k2.iterations.dtype == torch.int32 and k2.iterations.shape == ()
    assert k2.converged.dtype == torch.bool and k2.converged.shape == ()
    assert 1 <= int(k2.iterations) <= case.iterations
    assert not bool(k2.pose_covariance.any())
    assert not bool(k2.point_covariance.any())
    assert k2.point_covariance.shape == (case.points, 3, 3)
    assert bool(torch.isfinite(k2.points).all() & torch.isfinite(k2.error))


@pytest.mark.parametrize("name", ["tracker_512", "kitti_2048_huber"])
def test_point_information_is_the_plain_one_at_the_result(dev, name):
    """Each point's information is ``Hpp`` plus its prior at the kernel's
    own result, with no Huber scaling, as the plain body computes it
    there: the same products summed over two frames, so within float32
    rounding of the block's largest entry."""
    case = CASES[name]
    prob = make_problem(case, 11, dtype=torch.float32, device=dev)
    k2 = ba.ba_solve(prob, params_of(case))
    _, want, _, _, _ = ba._normal_equations(k2.poses, k2.points, prob)
    scale = want.abs().amax(dim=(-2, -1), keepdim=True)
    rel = float(((k2.point_information - want).abs() / scale).max())
    assert rel <= 1e-5, rel


def test_point_information_is_left_out_when_not_asked(dev):
    case = CASES["tracker_512"]
    card = make_problem(case, seed=3, dtype=torch.float32, device=dev)
    res = ba.ba_solve(card, params_of(case)._replace(
        compute_point_info=False))
    assert res.point_information is None


def _not_definite(dev, negative: bool):
    """A problem with the second frame unobserved and no damping (every
    point held by its prior, so that its own block stays invertible): the
    frame's block of the reduced system is exactly zero, so the plain
    factorisation fails and the jittered one (jitter eps * (1 + 1e10), the
    anchor's diagonal) succeeds; with a prior of -1e5 on the frame, below
    minus the jitter, both fail and every step is NaN."""
    case = Case(512, point_prior="full")
    prob = make_problem(case, seed=5, dtype=torch.float32, device=dev)
    mask = prob.obs_mask.clone()
    mask[1] = False
    info = prob.pose_prior_info.clone()
    if negative:
        info[1] = -1e5 * torch.eye(6, device=dev)
    prob = prob._replace(obs_mask=mask, pose_prior_info=info)
    params = params_of(case, lambda_init=0.0, lambda_min=0.0)
    return prob, params


def test_jittered_resolve_where_the_system_is_singular(dev):
    prob, params = _not_definite(dev, negative=False)
    plain32 = ba.ba_solve_plain(prob, params)
    cpu = prob._replace(**{k: (SE3(v.R.cpu().double(), v.t.cpu().double())
                               if isinstance(v, SE3) else
                               v.cpu() if v.dtype == torch.bool
                               else v.cpu().double())
                           for k, v in prob._asdict().items()})
    ref = ba.ba_solve_plain(cpu, params)
    k2 = ba.ba_solve(prob, params)
    torch.cuda.synchronize()
    # the unobserved frame stays where it started, bit for bit
    assert torch.equal(k2.poses.R[1], prob.poses0.R[1])
    assert torch.equal(k2.poses.t[1], prob.poses0.t[1])
    assert torch.equal(plain32.poses.R[1], prob.poses0.R[1])
    assert int(k2.iterations) >= 1 and bool(torch.isfinite(k2.error))
    g_k2, g_plain = gaps(k2, ref), gaps(plain32, ref)
    assert all(a <= JITTER_SLACK * b + f
               for a, b, f in zip(g_k2, g_plain, FLOOR)), (g_k2, g_plain)


def test_nan_steps_are_refused_where_no_solve_succeeds(dev):
    prob, params = _not_definite(dev, negative=True)
    plain32 = ba.ba_solve_plain(prob, params)
    k2 = ba.ba_solve(prob, params)
    torch.cuda.synchronize()
    for res in (plain32, k2):
        assert torch.equal(res.poses.R, prob.poses0.R)
        assert torch.equal(res.poses.t, prob.poses0.t)
        assert torch.equal(res.points, prob.points0)
        assert int(res.iterations) == params.max_iterations
        assert not bool(res.converged)
    assert float(k2.error) == pytest.approx(float(plain32.error), rel=1e-5)


def _bits(res: ba.BAResult) -> list:
    return [x.reshape(-1).view(torch.uint8).clone() for x in (
        res.poses.R, res.poses.t, res.points, res.error, res.iterations,
        res.converged, res.point_information)]


@pytest.mark.parametrize("name", ["tracker_512", "kitti_2048_huber"])
def test_two_calls_and_a_graph_replay_give_the_same_bits(dev, name):
    case = CASES[name]
    params = params_of(case)
    prob = make_problem(case, seed=7, dtype=torch.float32, device=dev)
    a, b = _bits(ba.ba_solve(prob, params)), _bits(ba.ba_solve(prob, params))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    n = ba_cuda.two_frame_solve.launches
    with torch.cuda.graph(graph, stream=stream):
        res = ba.ba_solve(prob, params)
    assert ba_cuda.two_frame_solve.launches == n + 1
    graph.replay()
    torch.cuda.synchronize()
    assert ba_cuda.two_frame_solve.launches == n + 1
    assert all(torch.equal(x, y) for x, y in zip(a, _bits(res)))


def _launched(prob, params, group=None) -> bool:
    n = ba_cuda.two_frame_solve.launches
    ba.ba_solve(prob, params, group)
    return ba_cuda.two_frame_solve.launches != n


def test_ba_solve_keeps_what_the_kernel_does_not_take_plain(dev):
    case = CASES["tracker_512"]
    params = params_of(case)
    prob = make_problem(case, seed=2, dtype=torch.float32, device=dev)
    assert _launched(prob, params)
    assert not _launched(prob, params._replace(compute_covariance=True))
    f64 = make_problem(case, seed=2, dtype=torch.float64, device=dev)
    assert not _launched(f64, params)
    three = prob._replace(
        poses0=SE3(*(torch.cat([x, x[1:]]) for x in prob.poses0)),
        pose_prior=SE3(*(torch.cat([x, x[1:]]) for x in prob.pose_prior)),
        pose_prior_info=torch.cat([prob.pose_prior_info,
                                   prob.pose_prior_info[1:]]),
        obs=torch.cat([prob.obs, prob.obs[1:]]),
        obs_mask=torch.cat([prob.obs_mask, prob.obs_mask[1:]]),
        obs_weight=torch.cat([prob.obs_weight, prob.obs_weight[1:]]))
    assert not _launched(three, params)
    big = make_problem(Case(ba_cuda.CAPACITY + 1), seed=2,
                       dtype=torch.float32, device=dev)
    assert not _launched(big, params)


def test_non_contiguous_inputs_are_made_contiguous_for_the_kernel(dev):
    """``sfm_refine``'s ``regulator`` gauge hands over an expanded point
    prior: ``ba_solve`` copies it, the kernel's wrapper would refuse it."""
    case = CASES["scale_only_500"]
    params = params_of(case)
    prob = make_problem(case, seed=4, dtype=torch.float32, device=dev)
    iso = (torch.eye(3, device=dev) * 100.0).expand(case.points, 3, 3)
    prob = prob._replace(point_prior_info=iso)
    with pytest.raises(ValueError, match="point_prior_info"):
        ba_cuda.two_frame_solve(prob, params)
    want = ba.ba_solve(prob._replace(point_prior_info=iso.contiguous()),
                       params)
    got = ba.ba_solve(prob, params)
    assert all(torch.equal(x, y) for x, y in zip(_bits(got), _bits(want)))


@pytest.mark.parametrize("bad", ["float64", "cpu_mask", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(dev, bad):
    case = CASES["tracker_512"]
    params = params_of(case)
    prob = make_problem(case, seed=1, dtype=torch.float32, device=dev)
    if bad == "float64":
        prob = prob._replace(obs=prob.obs.double())
    elif bad == "cpu_mask":
        prob = prob._replace(obs_mask=prob.obs_mask.cpu())
    else:
        prob = prob._replace(obs_weight=prob.obs_weight[:, :-1])
    n = ba_cuda.two_frame_solve.launches
    with pytest.raises(ValueError):
        ba_cuda.two_frame_solve(prob, params)
    assert ba_cuda.two_frame_solve.launches == n
