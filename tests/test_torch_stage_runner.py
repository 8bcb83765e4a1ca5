"""The tracker's stage runner (``vo_jit._StageRunner``) on the CPU, and the
PnP draw it takes as an input.

Off the card a runner runs its stages op by op on a fresh namespace, in
order, whatever ``cuda_graphs`` says, an eager stage (``vo_jit._eager``,
on the card the one that runs between replays) in its place like any
other, captures nothing and hands outputs on as they are (``own`` copies
only a graph's outputs; the captures and their bits are held on the card
by ``tests/test_torch_cuda.py``). A
TRACKING frame draws its P3P uniforms once, before the geometry chain
starts: the generator moves by exactly one ``(pnp_hypotheses, K)`` draw,
and the step given that draw as ``draws`` computes the same bits and
leaves its generator where it was.

The first 3 of ``tests/test_torch_spans.py``'s 4 frames of the two-plane
scene (240x320, focal 280, slanted background) at its small capacities:
EMPTY, INITIALIZING (bootstraps), TRACKING.
"""

import numpy as np
import pytest
import torch

from mvslam_tpu_torch.frontend import vo_jit
from mvslam_tpu_torch.ops.features import OrbParams
from mvslam_tpu_torch.utils.scene import render_planes_sequence

from test_torch_ref_common import one_torch_thread  # noqa: F401 (autouse)

H, W, FOCAL = 240, 320, 280.0
PARAMS = vo_jit.VoJitParams(orb=OrbParams(max_features=256),
                            map_capacity=512, ransac_hypotheses=128,
                            pnp_hypotheses=64, ba_old=192, ba_new=64)


@pytest.mark.parametrize("cuda_graphs", [True, False])
def test_runner_runs_its_stages_op_by_op_off_the_card(cuda_graphs):
    seen = []

    def double(v):
        seen.append("double")
        return dict(y=2 * v.x)

    def add(v):
        seen.append("add")
        return dict(z=v.y + v.c)

    runner = vo_jit._StageRunner((double, add), cuda_graphs)
    x = torch.arange(4.0)
    assert not runner.replays(x.device)
    run = runner.start(dict(x=x, c=1.0))
    assert run.v.x is x and not hasattr(run.v, "y")
    run.advance()
    assert seen == ["double"] and torch.equal(run.v.y, 2 * x)
    run.advance()
    assert seen == ["double", "add"]
    assert torch.equal(run.v.z, 2 * x + 1.0)
    assert run.own(run.v.z) is run.v.z
    assert runner.captures == {}
    # the next run starts from a fresh namespace
    assert not hasattr(runner.start(dict(x=x, c=1.0)).v, "z")


@pytest.mark.parametrize("cuda_graphs", [True, False])
def test_eager_stage_runs_in_its_place_off_the_card(cuda_graphs):
    """A stage marked ``_eager`` (on the card: run op by op between the
    replays of the others) is off the card one more stage of the chain:
    run in its place, its outputs added under their names for the stages
    after it, nothing captured, a fresh namespace each run."""
    seen = []

    def gram(v):
        seen.append("gram")
        return dict(g=[x[:, None] * x[None, :] + torch.eye(3) for x in v.x])

    @vo_jit._eager
    def solve(v):
        seen.append("solve")
        return dict(V=[torch.linalg.eigh(g)[1] for g in v.g])

    def pick(v):
        seen.append("pick")
        return dict(first=torch.stack([V[:, -1] for V in v.V]))

    assert solve.eager and not hasattr(gram, "eager")
    runner = vo_jit._StageRunner((gram, solve, pick), cuda_graphs)
    xs = [torch.tensor([1.0, 2.0, 2.0]), torch.tensor([0.0, 3.0, 4.0])]
    run = runner.start(dict(x=xs))
    run.advance()
    assert seen == ["gram"] and not hasattr(run.v, "V")
    run.advance()
    assert seen == ["gram", "solve"] and len(run.v.V) == 2
    for g, V in zip(run.v.g, run.v.V):
        assert torch.equal(V, torch.linalg.eigh(g)[1])
    run.advance()
    assert seen == ["gram", "solve", "pick"]
    # each leading eigenvector is its x, normalised, up to sign
    for x, e in zip(xs, run.v.first):
        assert torch.allclose(torch.abs(e), x / torch.linalg.norm(x),
                              atol=1e-6)
    assert runner.captures == {} and runner.prepare(dict(x=xs)) is None
    assert not hasattr(runner.start(dict(x=xs)).v, "first")


@pytest.fixture(scope="module")
def at_tracking():
    """The step, the state entering the scene's first TRACKING frame, that
    frame, ``K_inv`` and ``focal``."""
    # the 4-frame path of ``tests/test_torch_spans.py`` (a prefix rendered
    # alone is another scene)
    i = np.arange(4)
    ts = np.stack([i * 0.12, 0.02 * np.sin(i * 0.25), np.zeros(4)], 1)
    frames = render_planes_sequence(ts, h=H, w=W, focal=FOCAL, bg_slope=0.18)
    K_inv = torch.tensor(np.linalg.inv(
        [[FOCAL, 0, (W - 1) / 2], [0, FOCAL, (H - 1) / 2], [0, 0, 1]]),
        dtype=torch.float32)
    focal = torch.tensor(FOCAL)
    step = vo_jit.make_vo_step(PARAMS)
    state = vo_jit.vo_init_state(PARAMS, device="cpu", seed=1)
    for k in range(2):
        state, _ = step(state, torch.from_numpy(frames[k]), K_inv, focal)
    assert int(state.mode) == vo_jit.MODE_TRACKING
    return step, state, torch.from_numpy(frames[2]), K_inv, focal


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


def test_tracking_frame_draws_the_pnp_uniforms_once(at_tracking):
    step, state, image, K_inv, focal = at_tracking
    before = state.generator.get_state()
    mine = state._replace(generator=torch.Generator().set_state(before))
    drawn, out = step(mine, image, K_inv, focal)
    ref = torch.Generator().set_state(before)
    draws = torch.rand((PARAMS.pnp_hypotheses, PARAMS.orb.max_features),
                       generator=ref)
    assert torch.equal(drawn.generator.get_state(), ref.get_state())

    given = state._replace(generator=torch.Generator().set_state(before))
    s_given, o_given = step(given, image, K_inv, focal, draws)
    assert torch.equal(s_given.generator.get_state(), before)
    assert bool(out.success) and bool(o_given.success)
    for a, b in zip(list(drawn) + list(out), list(s_given) + list(o_given)):
        if isinstance(a, torch.Generator):
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
