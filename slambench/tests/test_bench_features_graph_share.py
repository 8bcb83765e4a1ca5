"""The reader of ``features.graph_share`` on made-up stages: the share of
the TRACKING frames whose ``vo_jit.pre`` holds ``vo_jit.pre.graphed``;
nothing where no frame entered in TRACKING, where the pass was not made,
and on a port without the span."""

import pytest

from slambench import cell as cells
from slambench import stages

NAME = "features.graph_share"


def _stages(pre: int, graphed: int) -> stages.Stages:
    by = {"vo_jit.pre": stages.Stage(host_s=[0.003] * pre)}
    if graphed:
        by["vo_jit.pre.graphed"] = stages.Stage(host_s=[0.002] * graphed)
    return stages.Stages(frames={"tracking": pre, "initializing": 1},
                         by_mode={"tracking": by})


@pytest.mark.parametrize("pre,graphed,share", [(6, 6, 100.0), (4, 1, 25.0),
                                               (5, 0, 0.0)])
def test_share_of_tracking_frames_that_replayed(monkeypatch, pre, graphed,
                                                share):
    reader = cells.load_reader(NAME)
    monkeypatch.setattr(stages, "of", lambda run: _stages(pre, graphed))
    assert reader.read(object()) == pytest.approx(share)


def test_nothing_to_read(monkeypatch):
    reader = cells.load_reader(NAME)
    no_tracking = stages.Stages(frames={"initializing": 2},
                                by_mode={"initializing": {}})
    monkeypatch.setattr(stages, "of", lambda run: no_tracking)
    assert reader.read(object()) is None
    monkeypatch.setattr(stages, "of", lambda run: None)
    assert reader.read(object()) is None


def test_port_without_the_span_reads_nothing(monkeypatch):
    """A parent's port lists spans but not ``vo_jit.pre.graphed``: no pass
    is made and the reader returns ``None``."""
    reader = cells.load_reader(NAME)

    def no_pass(run):
        raise AssertionError("a pass was made")

    monkeypatch.setattr(stages, "of", no_pass)
    monkeypatch.setattr(stages, "SPANS", tuple(
        n for n in stages.SPANS if n != reader.SPAN))
    assert reader.read(object()) is None


def test_entry_agrees_with_the_reader():
    cell = cells.resolve("tsukuba.track")
    (metric,) = [m for m in cell.per_layer if m.name == NAME]
    assert (metric.layer, metric.unit, metric.moves) == (
        "feature front", "%", "frame_ms_p90")
