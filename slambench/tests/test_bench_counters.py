"""The readers of the KITTI deployment's counters,
``features.keypoints_per_frame`` and ``geometry.huber_share``: the median
over the pass's TRACKING frames where the port gives the counter, nothing
where it cannot (a state without ``lf_mask``; a BA module without
``huber_share``, as before the counters), and the pass itself on the CPU
at a small size."""

import pytest
import torch

from bench_small import small_cell
from slambench import cell as cells
from slambench import counters

#: reader -> (counter, values on the pass's TRACKING frames, reading)
READERS = {
    "features.keypoints_per_frame": ("n_keypoints", [2000.0, 1987.0, 2000.0],
                                     2000.0),
    "geometry.huber_share": ("ba_robust", [0.04, 0.02, 0.0625, 0.03],
                             3.5),
}


class _Run:
    """A traced run as the readers see it (``run.Reading``'s fields)."""

    def __init__(self, profile=True):
        self.cell = self.frames = None
        self.device = "cpu"
        self.profile = object() if profile else None


def _run(profile=True):
    return _Run(profile)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_the_median_of_its_counter(monkeypatch, name):
    counter, values, want = READERS[name]
    reader = cells.load_reader(name)
    assert reader.COUNTER == counter and counters.available(counter)
    passes = []

    def fake_pass(cell, frames, device):
        passes.append(1)
        return {c: vals for c, vals, _ in READERS.values()}

    monkeypatch.setattr(counters, "counter_pass", fake_pass)
    run = _run()
    assert reader.read(run) == pytest.approx(want)
    assert reader.read(run) == pytest.approx(want)
    assert len(passes) == 1            # one pass a run


#: reader -> how a port without its counter is made: (object, attribute)
#: taken away
WITHOUT = {"features.keypoints_per_frame": "state",
           "geometry.huber_share": "ba"}


def _without(monkeypatch, what):
    if what == "state":
        class OldState(tuple):
            _fields = ("lf_xy", "lf_desc", "mode")

        monkeypatch.setattr(counters.program.vo_jit, "VoJitState", OldState)
    else:
        monkeypatch.delattr(counters.program.vo_jit.ba_mod, "huber_share")


@pytest.mark.parametrize("name", sorted(READERS))
def test_port_without_the_counter_reads_nothing(monkeypatch, name):
    """A port that cannot give the counter (the parent has no
    ``ba.huber_share``): the reader returns ``None``, and with neither
    counter no pass is made."""
    reader = cells.load_reader(name)
    _without(monkeypatch, WITHOUT[name])
    assert not counters.available(reader.COUNTER)
    assert reader.read(_run()) is None
    for other in set(WITHOUT.values()) - {WITHOUT[name]}:
        _without(monkeypatch, other)
    assert counters.counter_pass(None, None, "cpu") == {}


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read(monkeypatch, name):
    reader = cells.load_reader(name)
    monkeypatch.setattr(counters, "counter_pass",
                        lambda cell, frames, device: {"n_keypoints": [],
                                                      "ba_robust": []})
    assert reader.read(_run()) is None
    assert reader.read(_run(profile=False)) is None


def test_entries_agree_with_the_readers():
    cell = cells.resolve("kitti.track")
    got = {m.name: (m.layer, m.unit, m.moves) for m in cell.per_layer}
    assert got["features.keypoints_per_frame"] == (
        "feature front", "keypoints/frame", "frames_per_s")
    assert got["geometry.huber_share"] == ("geometry", "%", "frames_per_s")
    tsukuba = {m.name for m in cells.resolve("tsukuba.track").per_layer}
    assert not tsukuba & set(READERS)


def test_pass_on_the_cpu():
    """The pass over a small cut of kitti.track on the CPU: the counters of
    the frames from ``profile_start`` on that entered in TRACKING."""
    c = small_cell("kitti.track", frames=40)
    c = c._replace(config=dict(c.config, vo=dict(c.config["vo"],
                                                 huber_delta=2.4477)))
    from slambench import reference, scene

    frames = torch.empty((40, c.camera.height, c.camera.width),
                         dtype=torch.uint8)
    scene.render_uint8(torch.Generator().manual_seed(3_100_000_019),
                       c.traffic.ts, c.traffic.yaws, c.camera,
                       c.traffic.bg_slope, frames)
    assert reference.to_image(frames[0]).shape == frames.shape[1:]
    ba = counters.program.vo_jit.ba_mod
    got = counters.counter_pass(c, frames, "cpu")
    assert counters.program.vo_jit.ba_mod is ba      # the tap is taken off
    kp, share = got["n_keypoints"], got["ba_robust"]
    assert len(kp) == len(share) == c.traffic.profile_frames
    assert all(0 < k <= 256 for k in kp)
    assert all(0.0 <= s <= 1.0 for s in share)
