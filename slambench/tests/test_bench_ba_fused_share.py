"""The reader of ``geometry.ba_fused_share`` on made-up stages: the share of
the TRACKING frames whose ``vo_jit.track.ba`` holds
``vo_jit.track.ba.fused``; nothing where no frame entered in TRACKING,
where the pass was not made, and on a port without the span; the entry
lists both cells."""

import pytest

from slambench import cell as cells
from slambench import stages

NAME = "geometry.ba_fused_share"


def _stages(ba: int, fused: int) -> stages.Stages:
    by = {"vo_jit.track.ba": stages.Stage(host_s=[0.002] * ba)}
    if fused:
        by["vo_jit.track.ba.fused"] = stages.Stage(host_s=[1e-6] * fused)
    return stages.Stages(frames={"tracking": ba, "initializing": 1},
                         by_mode={"tracking": by})


@pytest.mark.parametrize("ba,fused,share", [(6, 6, 100.0), (4, 1, 25.0),
                                            (5, 0, 0.0)])
def test_share_of_tracking_frames_whose_ba_ran_the_kernel(monkeypatch, ba,
                                                          fused, share):
    reader = cells.load_reader(NAME)
    monkeypatch.setattr(stages, "of", lambda run: _stages(ba, fused))
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
    """The parent's port lists spans but not ``vo_jit.track.ba.fused``: no
    pass is made and the reader returns ``None``."""
    reader = cells.load_reader(NAME)

    def no_pass(run):
        raise AssertionError("a pass was made")

    monkeypatch.setattr(stages, "of", no_pass)
    monkeypatch.setattr(stages, "SPANS", tuple(
        n for n in stages.SPANS if n != reader.SPAN))
    assert reader.read(object()) is None


@pytest.mark.parametrize("workload", ["tsukuba.track", "kitti.track"])
def test_entry_agrees_with_the_reader(workload):
    reader = cells.load_reader(NAME)
    cell = cells.resolve(workload)
    (metric,) = [m for m in cell.per_layer if m.name == NAME]
    assert (metric.layer, metric.unit, metric.moves) == (
        reader.LAYER, reader.UNIT, reader.MOVES)
