"""The cell ``ssd_batch8_posed`` (configuration
``ssd_batch8_posed_750x900_d200``, traffic ``posed_batch8``) on the CPU at
240x320, D=48, block 9, two pairs a request from a pool of two: the
harness finds its files; the program passes its check, and the control,
a moved disparity, a pose outside the tolerance and a pair whose pose was
not used fail it; every new reader reads ``run_batch``'s recorded spans."""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, kineto
from benchmark.tests.small import run
from stereo_reconstruction_tpu_torch.utils import profiling
from stereo_reconstruction_tpu_torch.utils.profiling import SpanRecord

WORKLOAD = "ssd_batch8_posed"
SEED = 2**31 + 91
NEW_METRICS = ("pose_ms.batch", "pose_launches.batch", "idle_pose_ms.batch",
               "pose_features_ms.batch", "pose_ba_ms.batch", "rectify_host_ms.batch",
               "device_idle_pct.batch", "mfu.batch", "dense_ms")


def small_batch_cell() -> harness.Cell:
    """The cell at 240x320, D=48, block 9, two pairs a request. The
    configuration's pose tolerance (0.5 / 2 degrees) is stated for
    750x900; at 240x320 the port's poses land up to 1.19 / 5.30 degrees
    from the truth (``test_bench_posed.py``), so the check here holds them
    to 2 / 8 degrees."""
    c = harness.cell(harness.load_spec(), WORKLOAD)
    c = dataclasses.replace(c, config=copy.deepcopy(c.config), traffic=copy.deepcopy(c.traffic))
    c.config["image"] = {"height": 240, "width": 320}
    c.config["batch"] = 2
    c.config["pipeline"]["matcher"].update(max_disparity=48, block_size=9)
    c.config["pose_tolerance_deg"] = {"rotation": 2.0, "translation": 8.0}
    c.traffic.update(batch=2, pool=2, checked_pairs=2)
    return c


def test_the_harness_finds_every_file_of_the_cell():
    c = harness.cell(harness.load_spec(), WORKLOAD)
    assert c.config["name"] == "ssd_batch8_posed_750x900_d200" and c.config["batch"] == 8
    assert c.traffic["entry"] == "run_batch" and c.traffic["pose"] == "estimate"
    assert c.traffic["batch"] == c.traffic["pool"] == 8
    assert c.entry.Entry.pairs_per_request == 8 and callable(c.reference.pair)
    assert c.reference.padded_shape((750, 900)) == (752, 1024)
    assert c.config["pose_tolerance_deg"] == {"rotation": 0.5, "translation": 2.0}
    posed = harness.cell(harness.load_spec(), "ssd_pair_posed")
    assert c.config["pipeline"] == posed.config["pipeline"]
    assert c.config["image"] == posed.config["image"]
    assert [m["name"] for m in c.end_to_end] == ["pairs_per_s", "setup_s"]
    assert {m["moves"] for m in c.per_layer} == {"pairs_per_s"}
    assert {m["name"] for m in c.per_layer} == set(NEW_METRICS)
    for name in NEW_METRICS:
        assert callable(harness.metric_reader(name))


def test_program_passes_the_batch_check():
    r = run(small_batch_cell(), SEED)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["pairs_not_pose_ok"]["value"] == 0


def test_control_fails_the_batch_check():
    r = run(small_batch_cell(), SEED, control=True)
    assert not r["correct"]
    assert r["checks"]["disparity_mismatch_pct"]["value"] > 1.0


@pytest.mark.parametrize("what", ["disparity", "pose", "pose_ok"])
def test_an_altered_answer_fails_the_batch_check(what):
    c = small_batch_cell()

    class Broken(c.entry.Entry):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            inner = self.run_batch

            def run_batch(*args, **kw):
                res = inner(*args, **kw)
                if what == "disparity":
                    res.disparity[:, ::10] += 1.0
                elif what == "pose":
                    # pair 1's pose turned 5 degrees about the optical axis
                    c_, s_ = np.cos(np.radians(5.0)), np.sin(np.radians(5.0))
                    Rz = torch.tensor([[c_, -s_, 0], [s_, c_, 0], [0, 0, 1]],
                                      dtype=res.pose.pose.dtype)
                    pose = res.pose.pose.clone()
                    pose[1, :3, :3] = Rz @ pose[1, :3, :3]
                    res.pose = res.pose._replace(pose=pose)
                else:
                    res.pose_ok[1] = False
                return res

            self.run_batch = run_batch

    r = run(c, SEED, entry=Broken)
    assert not r["correct"], r["checks"]
    if what == "pose":
        assert r["failed"] == r["attempted"]
        assert r["checks"]["rotation_err_deg"]["value"] > 3.0
    if what == "pose_ok":
        assert r["failed"] == r["attempted"]
        assert r["checks"]["pairs_not_pose_ok"]["value"] == r["attempted"]


US = 1000


def _batch_request(request, t0, index0):
    """run_batch from t0 (us) with its stages' spans."""
    def s(name, parent, a, b):
        return SpanRecord(name, request, -1 if parent is None else index0 + parent,
                          (t0 + a) * US, (t0 + b) * US, None)
    return [s("run_batch", None, 0, 400), s("batch.upload", 0, 0, 5), s("pose", 0, 5, 300),
            s("pose.features", 2, 5, 200), s("pose.match", 2, 200, 210),
            s("pose.ransac", 2, 210, 220), s("pose.ba", 2, 220, 280),
            s("rectify.homographies", 0, 300, 316), s("dense", 0, 316, 400),
            s("rectify.warp", 8, 316, 317), s("disparity", 8, 317, 340)]


def test_new_readers_on_synthetic_spans(monkeypatch):
    records = _batch_request(0, 1000, 0) + _batch_request(1, 2000, 11)
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    dev = [kineto.Event("k", (1000 + a) * US, (1000 + a + 1) * US, True) for a in (10, 20, 30)]
    dev += [kineto.Event("k", (2000 + a) * US, (2000 + a + 2) * US, True) for a in (10, 320)]
    dev += [kineto.Event("cudaDeviceSynchronize", t * US, (t + 1) * US, False)
            for t in (900, 2500)]                                 # the traced window
    c = harness.cell(harness.load_spec(), WORKLOAD)
    ctx = harness.Context(c, harness.Window(2, 1.0, [0.4, 0.6], [{"pose": 0.3}, {"pose": 0.29}]),
                          8, 0.0, trace=dev, traced_requests=2, traced_seconds=1.6)

    def read(name):
        return harness.metric_reader(name)(ctx)

    assert read("pose_ms.batch") == pytest.approx(295.0)
    assert read("pose_launches.batch") == 2.0                 # 3 and 1
    assert read("idle_pose_ms.batch") == pytest.approx((292 + 293) / 2 / 1000)
    assert read("pose_features_ms.batch") == pytest.approx(0.195)
    assert read("pose_ba_ms.batch") == pytest.approx(0.060)
    assert read("rectify_host_ms.batch") == pytest.approx(0.016)
    assert read("dense_ms") == pytest.approx(0.084)
    assert read("mfu.batch") == pytest.approx(harness.metric_reader("mfu")(ctx))
    monkeypatch.setattr(profiling, "dropped", lambda: 1)
    for name in ("idle_pose_ms.batch", "pose_launches.batch", "pose_features_ms.batch",
                 "pose_ba_ms.batch", "rectify_host_ms.batch", "dense_ms"):
        assert read(name) is None, name


def test_every_new_reader_reads_a_recorded_trace():
    """A batch request recorded under a CPU profile (no device events: the
    launch count is 0 and the stage all idle)."""
    c = small_batch_cell()
    entry = c.entry.Entry(c, SEED, torch.device("cpu"))
    timings = entry.request(0, keep=False)
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            entry.request(1, keep=False)
        ctx = harness.Context(c, harness.Window(1, 1.0, [1.0], [timings]), 2, 0.0,
                              trace=kineto.events(prof), traced_requests=1,
                              traced_seconds=1.0)
        for name in NEW_METRICS:
            value = harness.metric_reader(name)(ctx)
            assert value is not None and np.isfinite(value), name
        assert harness.metric_reader("pose_launches.batch")(ctx) == 0
    finally:
        profiling.clear()
