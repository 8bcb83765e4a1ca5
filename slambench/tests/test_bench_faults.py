"""The whole run on the CPU at a small size, the card check skipped, with
the timed path broken underneath: ``correct`` comes out false for each
fault a cell can have (one card, so no exchange between cards to leave
out). The sound run beside them passes."""

import pytest
import torch

from bench_small import small_cell
from mvslam_tpu_torch.frontend import vo_jit
from slambench import program, run

SEED = 2_900_000_017
SECONDS = 8.0


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _run(workload="tsukuba.track"):
    return run.run_cell(small_cell(workload), SEED, SECONDS, False, "cpu")


def _wrap_step(monkeypatch, wrapper):
    build = program.tracker

    def tracker(config, K, device):
        t = build(config, K, device)
        return t._replace(step=wrapper(t.step))

    monkeypatch.setattr(program, "tracker", tracker)


def test_sound_run_is_correct():
    res = _run()
    assert res["numbers"].failed() == [], dict(res["numbers"])
    assert res["correct"]
    # lost frames are answers: ``failed`` counts steps that raised or gave
    # a non-finite pose, so two sets of the same seeds agree on it
    assert res["failed"] == 0 and 0 <= res["lost"] < res["attempted"]


def test_state_left_unchanged(monkeypatch):
    def wrapper(step):
        def stuck(state, *args, **kwargs):
            _, out = step(state, *args, **kwargs)
            return state, out
        return stuck
    _wrap_step(monkeypatch, wrapper)
    res = _run()
    assert not res["correct"]
    assert "kp_miss" in res["numbers"].failed()


def test_half_the_keypoints_left_out(monkeypatch):
    detect = vo_jit.orb_detect

    def half(img, params):
        f = detect(img, params)
        keep = torch.arange(f.mask.shape[0], device=f.mask.device) % 2 == 0
        return f._replace(mask=f.mask & keep)
    monkeypatch.setattr(vo_jit, "orb_detect", half)
    res = _run()
    assert not res["correct"]
    assert "kp_miss" in res["numbers"].failed()


def test_pose_altered_where_produced(monkeypatch):
    def wrapper(step):
        count = [0]

        def altered(state, *args, **kwargs):
            state, out = step(state, *args, **kwargs)
            count[0] += 1
            if count[0] % 7 == 0:
                out = out._replace(pose_t=2.0 * out.pose_t)
            return state, out
        return altered
    _wrap_step(monkeypatch, wrapper)
    res = _run()
    assert not res["correct"]
    assert "traj_err" in res["numbers"].failed()
