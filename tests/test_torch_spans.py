"""The tracker step's spans (``vo_jit.SPANS``, ``utils.timing.span``) on the
CPU: under ``torch.profiler`` a run that bootstraps and then tracks gives
every span but ``vo_jit.pre.graphed``, ``vo_jit.track.graphed`` and
``vo_jit.init.graphed``, nested and in the order ``vo_jit.py`` lists them,
and the spans change nothing the tracker computes: poses, modes and state
are bit-equal with the profiler on and off, same seed and same draws. The
three ``.graphed`` spans mark the CUDA graphs' replays: a tracker on the
CPU builds no graph and never opens them, and its step is the one
``vo_jit._make_vo_step_fns(..., cuda_graphs=False)`` gives, bit for bit.

4 frames of the two-plane scene (240x320, focal 280, slanted background)
at small capacities: EMPTY, INITIALIZING (bootstraps), TRACKING twice.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mvslam_tpu_torch.frontend import vo_jit
from mvslam_tpu_torch.ops.features import OrbParams
from mvslam_tpu_torch.utils.scene import render_planes_sequence

from test_torch_ref_common import one_torch_thread  # noqa: F401 (autouse)

H, W, FOCAL = 240, 320, 280.0
N_FRAMES = 4
PARAMS = vo_jit.VoJitParams(orb=OrbParams(max_features=256),
                            map_capacity=512, ransac_hypotheses=128,
                            pnp_hypotheses=64, ba_old=192, ba_new=64)
#: a span's parent: the span that holds it on the host
PARENT = {"vo_jit.pre": None, "vo_jit.combine": None,
          "vo_jit.empty": "vo_jit.combine", "vo_jit.init": "vo_jit.combine",
          "vo_jit.track": "vo_jit.combine"}


def _parent(name):
    if name in PARENT:
        return PARENT[name]
    return name.rsplit(".", 1)[0]


#: opened only where the geometry stages replay as CUDA graphs
GRAPHED = "vo_jit.track.graphed"
#: opened only where the feature half replays as CUDA graphs
PRE_GRAPHED = "vo_jit.pre.graphed"
#: opened only where the bootstrap's slots and refine replay as CUDA graphs
INIT_GRAPHED = "vo_jit.init.graphed"


def _run(profiled, step=None):
    i = np.arange(N_FRAMES)
    ts = np.stack([i * 0.12, 0.02 * np.sin(i * 0.25), np.zeros(N_FRAMES)],
                  1)
    frames = render_planes_sequence(ts, h=H, w=W, focal=FOCAL, bg_slope=0.18)
    K_inv = torch.tensor(np.linalg.inv(
        [[FOCAL, 0, (W - 1) / 2], [0, FOCAL, (H - 1) / 2], [0, 0, 1]]),
        dtype=torch.float32)
    step = vo_jit.make_vo_step(PARAMS) if step is None else step
    state = vo_jit.vo_init_state(PARAMS, device="cpu", seed=1)
    states, outs, events = [], [], None

    def run():
        nonlocal state
        for k in range(N_FRAMES):
            state, out = step(state, torch.from_numpy(frames[k]), K_inv,
                              torch.tensor(FOCAL))
            states.append(state)
            outs.append(out)

    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
        events = prof.profiler.kineto_results.events()
    else:
        run()
    assert not step.track_graphs and not step.pre_graphs
    assert not any(step.init_graphs.values())
    return states, outs, events


@pytest.fixture(scope="module")
def runs():
    return _run(False), _run(True)


def _assert_bit_equal(run_a, run_b):
    (s_a, o_a, _), (s_b, o_b, _) = run_a, run_b
    assert len(s_a) == len(s_b) == N_FRAMES
    for a, b in zip(s_a + o_a, s_b + o_b):
        for x, y in zip(a, b):
            if isinstance(x, torch.Generator):
                x, y = x.get_state(), y.get_state()
            assert x.dtype == y.dtype and x.shape == y.shape
            # bits, so that a NaN equals itself
            assert torch.equal(x.reshape(-1).view(torch.uint8),
                               y.reshape(-1).view(torch.uint8))


def test_spans_nest_in_the_listed_order(runs):
    _, (_, outs, events) = runs
    assert [int(o.mode) for o in outs] == [
        vo_jit.MODE_INITIALIZING] + [vo_jit.MODE_TRACKING] * 3
    spans = sorted(((e.start_ns(), -e.duration_ns(), e.name(),
                     e.start_ns() + e.duration_ns()) for e in events
                    if e.name().startswith("vo_jit.")))
    assert {s[2] for s in spans} == set(vo_jit.SPANS) - {
        GRAPHED, PRE_GRAPHED, INIT_GRAPHED}
    # one frame per "vo_jit.pre"; each frame's spans in the listed order
    frames, stack = [], []
    for a, _, name, b in spans:
        while stack and stack[-1][1] <= a:
            stack.pop()
        assert (stack[-1][0] if stack else None) == _parent(name), name
        assert not stack or b <= stack[-1][1], name
        if name == "vo_jit.pre":
            frames.append([])
        frames[-1].append(name)
        stack.append((name, b))
    head = ["vo_jit.pre", "vo_jit.pre.orb", "vo_jit.pre.templates",
            "vo_jit.combine"]
    track = [n for n in vo_jit.SPANS
             if n.startswith("vo_jit.track") and n != GRAPHED]
    init = [n for n in vo_jit.SPANS
            if n.startswith("vo_jit.init") and n != INIT_GRAPHED]
    assert frames == [head + ["vo_jit.empty"], head + init,
                      head + track, head + track]
    for names in frames:
        assert [vo_jit.SPANS.index(n) for n in names] == sorted(
            vo_jit.SPANS.index(n) for n in names)


def test_profiler_changes_nothing_the_tracker_computes(runs):
    _assert_bit_equal(*runs)


def test_graphed_span_is_listed_around_the_geometry_stages():
    i = vo_jit.SPANS.index(GRAPHED)
    assert vo_jit.SPANS[i - 1] == "vo_jit.track"
    assert vo_jit.SPANS[i + 1] == "vo_jit.track.associate"


def test_pre_graphed_span_is_listed_around_the_feature_stages():
    i = vo_jit.SPANS.index(PRE_GRAPHED)
    assert vo_jit.SPANS[i - 1] == "vo_jit.pre"
    assert vo_jit.SPANS[i + 1:i + 3] == ("vo_jit.pre.orb",
                                         "vo_jit.pre.templates")


def test_init_graphed_span_is_listed_around_the_slots_and_refine():
    i = vo_jit.SPANS.index(INIT_GRAPHED)
    assert vo_jit.SPANS[i - 1] == "vo_jit.init"
    assert vo_jit.SPANS[i + 1:i + 4] == ("vo_jit.init.slots",
                                         "vo_jit.init.refine",
                                         "vo_jit.init.seed")


def test_cpu_tracker_never_opens_the_init_graphed_span(runs):
    _, (_, outs, events) = runs
    names = [e.name() for e in events]
    assert names.count("vo_jit.init.slots") == 1
    assert names.count("vo_jit.init.refine") == 1
    assert INIT_GRAPHED not in names


def test_cpu_tracker_never_opens_the_graphed_span(runs):
    _, (_, outs, events) = runs
    assert sum(int(o.mode) == vo_jit.MODE_TRACKING for o in outs) == 3
    names = {e.name() for e in events}
    assert "vo_jit.track.ba" in names and GRAPHED not in names


def test_cpu_tracker_never_opens_the_pre_graphed_span(runs):
    _, (_, outs, events) = runs
    names = [e.name() for e in events]
    assert names.count("vo_jit.pre.orb") == N_FRAMES
    assert PRE_GRAPHED not in names


def test_step_equals_the_eager_builder_on_the_cpu(runs):
    eager, _, _ = vo_jit._make_vo_step_fns(PARAMS, cuda_graphs=False)
    _assert_bit_equal(runs[0], _run(False, eager))
