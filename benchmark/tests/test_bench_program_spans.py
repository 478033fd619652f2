"""The readers of the program's spans (``metrics/_program.py`` and the
metrics on it) on synthetic span and event lists: the device's idle time
inside a span with overlapping kernels and kernels cut by its edges, a
span's self time, requests outside the traced window, and no value
where the program's buffer dropped a span or the program has no
recorder."""

from __future__ import annotations

import pytest

from benchmark import harness, kineto
from benchmark.metrics import _program
from stereo_reconstruction_tpu_torch.utils import profiling
from stereo_reconstruction_tpu_torch.utils.profiling import SpanRecord

US = 1000


def dev(a, b, name="k"):
    return kineto.Event(name, a * US, b * US, True)


def host(a, b, name="cudaLaunchKernel"):
    return kineto.Event(name, a * US, b * US, False)


def fixed_request(request, t0, index0):
    """One run_pair request from t0 (us): run_pair [t0, t0 + 100], its
    stages, an upload inside rectify and two downloads."""
    def s(name, parent, a, b, device_ms=None):
        return SpanRecord(name, request, -1 if parent is None else index0 + parent,
                          (t0 + a) * US, (t0 + b) * US, device_ms)
    return [s("run_pair", None, 0, 100),       # index0
            s("pose", 0, 1, 2),
            s("rectify", 0, 2, 40),             # index0 + 2
            s("rectify.upload", 2, 3, 8),
            s("rectify.homographies", 2, 8, 20),
            s("disparity", 0, 45, 70),
            s("entry.download", 0, 70, 74),
            s("recon", 0, 75, 95),
            s("recon.upload", 7, 76, 78),
            s("entry.download", 0, 96, 99)]


def context(trace, workload="ssd_pair_fixedF"):
    spec = harness.load_spec()
    c = harness.cell(spec, workload)
    return harness.Context(c, harness.Window(0, 1.0, [], []), 1, 0.0, trace=trace,
                           traced_requests=2, traced_seconds=1.0)


@pytest.fixture
def program(monkeypatch):
    """Replace the program's recorded spans by a list the test fills."""
    records = []
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    return records


def test_idle_inside_a_span_with_overlapping_and_clipped_kernels():
    # span [100, 200]: kernels [90, 110] (cut at the start), [120, 150]
    # and [140, 160] (overlapping), [190, 230] (cut at the end)
    trace = [dev(90, 110), dev(120, 150), dev(140, 160), dev(190, 230), dev(300, 310)]
    busy = _program.busy_intervals(trace)
    assert busy == [(90 * US, 110 * US), (120 * US, 160 * US), (190 * US, 230 * US),
                    (300 * US, 310 * US)]
    ends = [b for _, b in busy]
    # busy inside: 10 + 40 + 10 = 60 of 100
    assert _program.idle_ns(busy, ends, 100 * US, 200 * US) == 40 * US
    assert _program.idle_ns(busy, ends, 230 * US, 300 * US) == 70 * US      # all idle
    assert _program.idle_ns(busy, ends, 125 * US, 135 * US) == 0            # all busy
    # the same as kineto.busy_ns over the events clipped by hand
    clipped = [dev(100, 110), dev(120, 150), dev(140, 160), dev(190, 200)]
    assert _program.idle_ns(busy, ends, 100 * US, 200 * US) == 100 * US - kineto.busy_ns(clipped)


def test_self_time_less_the_named_children():
    req = list(enumerate(fixed_request(0, 0, 0)))
    stages = ("pose", "rectify", "disparity", "recon")
    # 100 less pose 1, rectify 38, disparity 25, recon 20
    assert _program.self_ns(req, "run_pair", stages) == 16 * US
    # children overlapping each other count once
    overlapping = [(0, SpanRecord("a", 0, -1, 0, 100 * US, None)),
                   (1, SpanRecord("b", 0, 0, 10 * US, 50 * US, None)),
                   (2, SpanRecord("b", 0, 0, 40 * US, 60 * US, None)),
                   (3, SpanRecord("c", 0, 1, 20 * US, 30 * US, None))]   # a grandchild
    assert _program.self_ns(overlapping, "a", ("b", "c")) == 50 * US
    assert _program.self_ns(overlapping, "z", ("b",)) is None


def test_fixed_readers_skip_requests_outside_the_traced_window(program):
    # request 0 from t=0 (before the trace), requests 1 and 2 inside it
    program += fixed_request(0, 0, 0) + fixed_request(1, 1000, 10) + fixed_request(2, 2000, 20)
    # request 1's device work: the whole upload, half of the homographies
    # (no device work really; it shows the clipping), the disparity from
    # 50 to 70, nothing in recon; request 2 busy through its rectify
    trace = [host(900, 901, "cudaDeviceSynchronize"),
             dev(1003, 1008), dev(1008, 1014), dev(1050, 1070),
             dev(2002, 2040), host(2150, 2151, "cudaDeviceSynchronize")]
    ctx = context(trace)

    def read(name):
        return harness.metric_reader(name)(ctx)

    assert read("rectify_host_ms") == pytest.approx(0.012)
    assert read("copy_ms") == pytest.approx((5 + 4 + 2 + 3) / 1000)
    assert read("entry_self_ms") == pytest.approx(0.016)
    # rectify [2, 40]: request 1 idle 38 - 11 = 27, request 2 idle 0
    assert read("idle_rectify_ms") == pytest.approx(13.5 / 1000)
    # disparity [45, 70]: request 1 busy from 50, idle 5; request 2 idle 25
    assert read("idle_disparity_ms") == pytest.approx(15 / 1000)
    assert read("idle_recon_ms") == pytest.approx(20 / 1000)
    assert set(_program.requests(ctx)) == {1, 2}


def test_perceptual_readers_sum_device_time_per_search(program):
    def search(request, t0, index0, tower, distance):
        out = [SpanRecord("compute_disparity", request, -1, t0 * US, (t0 + 100) * US, None)]
        for b, (t, d) in enumerate(zip(tower, distance)):
            a = t0 + 1 + 10 * b
            out += [SpanRecord("perceptual.tower", request, index0, a * US, (a + 5) * US, t),
                    SpanRecord("perceptual.distance", request, index0, (a + 5) * US,
                               (a + 9) * US, d)]
        return out

    program += search(0, 0, 0, [4.0, 5.0], [1.0, 1.5]) + search(1, 200, 5, [6.0, 7.0], [2.0, 2.5])
    ctx = context([dev(0, 300)], "perceptual_rectified_pair")
    assert harness.metric_reader("vgg_tower_ms")(ctx) == pytest.approx(11.0)
    assert harness.metric_reader("lpips_distance_ms")(ctx) == pytest.approx(3.5)


def test_no_value_when_spans_were_dropped(program, monkeypatch):
    program += fixed_request(0, 1000, 0)
    ctx = context([host(900, 901), dev(1003, 1008), host(1200, 1201)])
    assert harness.metric_reader("rectify_host_ms")(ctx) == pytest.approx(0.012)
    monkeypatch.setattr(profiling, "dropped", lambda: 1)
    for name in ("rectify_host_ms", "copy_ms", "entry_self_ms", "idle_rectify_ms",
                 "idle_disparity_ms", "idle_recon_ms", "vgg_tower_ms", "lpips_distance_ms"):
        assert harness.metric_reader(name)(ctx) is None, name


def test_no_value_from_a_program_without_the_recorder(monkeypatch):
    """A program without ``spans`` (the commit before the recorder) gives
    the readers nothing to read: they return None and raise nothing."""
    monkeypatch.delattr(profiling, "spans")
    ctx = context([host(900, 901), dev(1003, 1008)])
    for name in ("copy_ms", "idle_recon_ms", "vgg_tower_ms"):
        assert harness.metric_reader(name)(ctx) is None
    assert _program.requests(context([])) == {}
