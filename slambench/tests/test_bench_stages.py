"""The stage reduction (``slambench/stages.py``) on made-up events: device
events go to the spans that hold their launch call on the host, not their
start on the device; self time is a span's time less its children's; host
reads and their wait, and the idle time by span with gaps outside the
program. The port's spans leave the traced window's own readings
(``trace.reduce``) on the device as they were. Each stage metric's reader
on a made-up profile, and with nothing to read.

On the card (marked ``cuda``): on one TRACKING frame of the cell's scene
the reads the trace counts equal the synchronising sites that
``utils.timing.sync_sites`` records, the launches by span add up to the
frame's device events, and ``trace.reduce`` counts those events alone."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from slambench import cell as cells
from slambench import program, scene, serve, stages, trace

CPU = torch.autograd.DeviceType.CPU
CUDA = torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, start, end, device=CPU, act=None, corr=0):
        self._n, self._a, self._b = name, start, end
        self._d, self._act, self._corr = device, act, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return self._d

    def start_thread_id(self):
        return 1

    def correlation_id(self):
        return self._corr

    def __getattr__(self, name):
        if name == "activity_type" and self._act:
            return lambda: self._act
        raise AttributeError(name)


def _launch(corr, at, start, end, name="mul_kernel", call="cudaLaunchKernel"):
    """A device event and the host call that launched it."""
    return [Event(call, at, at + 5, corr=corr),
            Event(name, start, end, CUDA, corr=corr)]


def _frame(mode="tracking"):
    """One frame, 0-1000 ns: the feature half at 10-200 and the TRACKING
    branch at 220-890, a kernel launched in ``pnp`` that starts on the
    device in ``ba``, a pageable copy and two reads in the branch, and a
    copy launched outside every program span."""
    ev = [
        Event(trace.WINDOW, 0, 1000),
        Event(trace.FRAME + mode, 0, 1000),
        Event("vo_jit.pre", 10, 200), Event("vo_jit.pre.orb", 15, 150),
        Event("vo_jit.combine", 210, 900), Event("vo_jit.track", 220, 890),
        Event("vo_jit.track.associate", 221, 229),
        Event("vo_jit.track.pnp", 230, 400),
        Event("vo_jit.track.triangulate", 400, 410),
        Event("vo_jit.track.ba", 410, 800),
        Event("aten::mul", 500, 506),
        Event("cudaStreamSynchronize", 600, 610, corr=90),
        Event("cudaStreamSynchronize", 860, 870, corr=91),
    ]
    ev += _launch(1, 30, 40, 60, "fast_nms_harris_pyramid_kernel")
    ev += _launch(2, 390, 415, 500)
    ev += _launch(3, 500, 510, 520, call="cuLaunchKernel")
    ev += [Event("cudaMemcpyAsync", 840, 860, corr=5),
           Event("Memcpy DtoH (Device -> Pageable)", 845, 855, CUDA, corr=5)]
    ev += _launch(4, 950, 960, 970, "Memcpy HtoD (Pinned -> Device)",
                  "cudaMemcpyAsync")
    return ev


def test_launches_go_to_the_span_of_their_launch():
    st = stages.reduce(_frame())
    s = {n: st.stage("tracking", n) for n in stages.SPANS
         if st.stage("tracking", n) is not None}
    assert st.frames == {"tracking": 1} and st.unlinked == 0
    # the kernel launched at 390 in pnp starts on the device in ba
    assert s["vo_jit.track.pnp"].launches == [1]
    assert s["vo_jit.track.pnp"].busy_s == pytest.approx([85e-9])
    assert s["vo_jit.track.ba"].launches == [1]
    assert s["vo_jit.track.ba"].busy_s == pytest.approx([10e-9])
    assert s["vo_jit.track.associate"].launches == [0]
    assert s["vo_jit.track"].launches == [3]       # pnp, ba, the copy
    assert s["vo_jit.pre"].launches == s["vo_jit.pre.orb"].launches == [1]
    assert st.kernels["tracking"] == 5 and st.outside["tracking"] == 1
    assert st.crossed == {"tracking": 0}
    assert (s["vo_jit.pre"].launches[0] + s["vo_jit.combine"].launches[0]
            + st.outside["tracking"]) == st.kernels["tracking"]
    # self time: the span less its children
    assert s["vo_jit.track"].host_s == pytest.approx([670e-9])
    assert s["vo_jit.track"].self_s == pytest.approx([(670 - 578) * 1e-9])
    assert s["vo_jit.combine"].self_s == pytest.approx([20e-9])
    assert s["vo_jit.pre"].self_s == pytest.approx([55e-9])
    assert s["vo_jit.track.ba"].self_s == s["vo_jit.track.ba"].host_s


def test_reads_and_idle_by_span():
    st = stages.reduce(_frame())
    ba, track = (st.stage("tracking", n) for n in ("vo_jit.track.ba",
                                                   "vo_jit.track"))
    assert ba.reads == [1] and ba.wait_s == pytest.approx([10e-9])
    # the pageable copy blocks the host: its time is wait, not a read
    assert track.reads == [2]
    assert track.wait_s == pytest.approx([(10 + 20 + 10) * 1e-9])
    assert st.stage("tracking", "vo_jit.combine").reads == [2]
    assert st.stage("tracking", "vo_jit.pre").reads == [0]
    # device busy 40-60, 415-500, 510-520, 845-855, 960-970
    assert dict(st.idle_by_span) == pytest.approx({
        "vo_jit.track.pnp": 355e-9, "vo_jit.track.ba": 335e-9,
        stages.OUTSIDE: 135e-9, "vo_jit.pre.orb": 40e-9})


def test_a_device_event_without_its_launch_call_goes_by_its_start():
    ev = [e for e in _frame() if not (e.name() == "cudaLaunchKernel"
                                      and e.correlation_id() == 2)]
    st = stages.reduce(ev)
    assert st.unlinked == 1
    assert st.stage("tracking", "vo_jit.track.pnp").launches == [0]
    assert st.stage("tracking", "vo_jit.track.ba").launches == [2]


def test_an_event_that_starts_past_its_frame_is_counted_apart():
    """Launched in the frame, it starts on the device after the frame's
    span: the count by device start leaves it out, ``crossed`` counts it."""
    ev = [e for e in _frame() if e.name() != trace.WINDOW]
    ev += [Event(trace.WINDOW, 0, 1100)] + _launch(6, 880, 1010, 1020)
    st = stages.reduce(ev)
    assert st.kernels["tracking"] == 5 and st.crossed["tracking"] == 1
    assert st.stage("tracking", "vo_jit.track").launches == [4]
    assert (st.stage("tracking", "vo_jit.pre").launches[0]
            + st.stage("tracking", "vo_jit.combine").launches[0]
            + st.outside["tracking"]) == 6


def _mirrors(act):
    """The spans mirrored on the device, with or without an activity
    type, as some torch versions give ``record_function``'s."""
    return [Event(n, a + 1, b - 1, CUDA, act=act, corr=7)
            for n, a, b in (("vo_jit.track.ba", 410, 800),
                            ("vo_jit.pre", 10, 200))]


@pytest.mark.parametrize("act", [None, "gpu_user_annotation"])
def test_span_mirrors_on_the_device_change_no_stage(act):
    a, b = stages.reduce(_frame()), stages.reduce(_frame() + _mirrors(act))
    assert a == b


def test_port_spans_leave_the_window_readings_on_the_device():
    """The port's spans are host ops with no mirror on the device: the
    window's device time, per-mode readings and device ops are as without
    them. Its idle gaps name the innermost program span where they said
    ``host (no op)``; gaps inside torch's own ops keep their names."""
    ev = _frame()
    bare = [e for e in ev if not e.name().startswith("vo_jit.")]
    a = trace.reduce(bare, program.K1_KERNEL)
    b = trace.reduce(ev, program.K1_KERNEL)
    assert (a.busy_s, a.window_s, a.device_ops) == (b.busy_s, b.window_s,
                                                    b.device_ops)
    assert a.by_mode == b.by_mode
    assert a.mode("tracking").kernels == stages.reduce(ev).kernels["tracking"]
    ga, gb = dict(a.idle_gaps), dict(b.idle_gaps)
    spans = {k: v for k, v in gb.items() if k.startswith("vo_jit.")}
    host = "host (no op)"
    assert spans and gb[host] + sum(spans.values()) == pytest.approx(ga[host])
    assert ({k: v for k, v in gb.items() if k != host and k not in spans}
            == {k: v for k, v in ga.items() if k != host} != {})


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------

READS = {
    "geometry.associate_ms": 8e-6, "geometry.pnp_ms": 170e-6,
    "geometry.triangulate_ms": 10e-6, "geometry.ba_ms": 390e-6,
    "vo_jit.host_reads_per_frame": 2.0, "vo_jit.track.wait_ms": 40e-6,
}


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_on_a_made_up_profile(monkeypatch, name):
    reader = cells.load_reader(name)
    monkeypatch.setattr(stages, "of", lambda run: stages.reduce(_frame()))
    assert reader.read(object()) == pytest.approx(READS[name])
    monkeypatch.setattr(stages, "of",
                        lambda run: stages.reduce(_frame("initializing")))
    assert reader.read(object()) is None


class _Run:
    profile = object()


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_reads_nothing_from_a_port_without_spans(monkeypatch, name):
    """The parent's port has no spans: no pass is made and the reader
    returns ``None``; likewise where the window gave no profile."""
    reader = cells.load_reader(name)

    def no_pass(*args):
        raise AssertionError("a pass was made")

    monkeypatch.setattr(stages, "profiled_pass", no_pass)
    monkeypatch.setattr(stages, "SPANS", ())
    assert reader.read(_Run()) is None
    monkeypatch.setattr(stages, "SPANS", ("vo_jit.pre",))
    run = _Run()
    run.profile = None
    assert reader.read(run) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_trace_reads_equal_sync_sites_on_a_tracking_frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the reads are the card's")
    from mvslam_tpu_torch.utils import timing

    cell = cells.resolve("tsukuba.track")
    dev = torch.device("cuda")
    tr, n = cell.traffic, 40
    frames = torch.empty((n, cell.camera.height, cell.camera.width),
                         dtype=torch.uint8, pin_memory=True)
    scene.render_uint8(torch.Generator(device=dev).manual_seed(2_900_000_303),
                       tr.ts[:n], tr.yaws[:n], cell.camera, tr.bg_slope,
                       frames)
    session = serve.Session(cell, frames, 2_900_000_303, dev)
    session.warm_up()
    t, log = session.trk, serve.Log()
    state, entry, i = session.fresh(), program.MODE_EMPTY, 0
    while entry != program.MODE_TRACKING or i < 4:
        state, _, host = session._frame(i, state, entry, log, False)
        entry, i = int(host[12]), i + 1
    img = session.image(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            with record_function(trace.FRAME + "tracking"):
                _, sites = timing.sync_sites(
                    lambda: t.step(state, img, t.K_inv, t.focal))
            torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    st = stages.reduce(events)
    pre, comb = (st.stage("tracking", n) for n in ("vo_jit.pre",
                                                    "vo_jit.combine"))
    assert sites and pre.reads[0] + comb.reads[0] == len(sites), sites
    assert st.unlinked == 0
    assert (pre.launches[0] + comb.launches[0] + st.outside["tracking"]
            == st.kernels["tracking"] > 0)
    window = trace.reduce(events, program.K1_KERNEL)
    assert window.mode("tracking").kernels == st.kernels["tracking"]
    assert not any(name.startswith("vo_jit.")
                   for name, _ in window.device_ops)
