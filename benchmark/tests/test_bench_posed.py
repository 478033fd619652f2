"""The cell ``ssd_pair_posed`` (configuration ``ssd_posed_750x900_d200``,
traffic ``posed_pool4``) on the CPU at 240x320, D=48, block 9: the
harness finds its files; the program passes its check, and the control,
an altered disparity and a pose outside the tolerance fail it; the
reference's scaled Loop-Zhang equals the program's; every new reader
reads a recorded trace."""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, kineto, scenes
from benchmark.reference import loop_zhang as ref_lz
from benchmark.reference import loop_zhang_scaled as ref_lz_scaled
from benchmark.tests.small import run
from stereo_reconstruction_tpu_torch.rectify import loop_zhang as prog_lz
from stereo_reconstruction_tpu_torch.utils import profiling
from stereo_reconstruction_tpu_torch.utils.profiling import SpanRecord

WORKLOAD = "ssd_pair_posed"
SEED = 2**31 + 77
NEW_METRICS = ("pose_ms", "idle_pose_ms", "pose_launches", "pose_features_ms",
               "pose_ransac_ms", "pose_ba_ms", "mfu.posed", "device_idle_pct.posed")
# the F the port's pose stage found for seed 3000000005, scene 0, request
# 0's CPU draws, at 750x900: its A's last pivot is -1.1444e-5
WITNESS_F = np.array([
    [6.5811555316486192e-08, -3.3362659905833425e-06, 2.3756748996675014e-03],
    [5.1497413551260252e-06, 4.1241560211346950e-07, 1.7570877447724342e-02],
    [-3.2405538950115442e-03, -1.8987802788615227e-02, 9.9965721368789673e-01],
])


def small_posed_cell() -> harness.Cell:
    """The cell at 240x320, D=48, block 9. The configuration's pose
    tolerance (0.5 / 2 degrees) is stated for 750x900; at 240x320 the
    port's poses land up to 1.19 / 5.30 degrees from the truth (16
    requests of 4 seeds, BA converged), so the check here holds them to
    2 / 8 degrees."""
    c = harness.cell(harness.load_spec(), WORKLOAD)
    c = dataclasses.replace(c, config=copy.deepcopy(c.config))
    c.config["image"] = {"height": 240, "width": 320}
    c.config["pipeline"]["matcher"].update(max_disparity=48, block_size=9)
    c.config["pose_tolerance_deg"] = {"rotation": 2.0, "translation": 8.0}
    return c


def test_the_harness_finds_every_file_of_the_cell():
    c = harness.cell(harness.load_spec(), WORKLOAD)
    assert c.config["name"] == "ssd_posed_750x900_d200"
    assert c.traffic["pose"] == "estimate" and c.traffic["entry"] == "run_pair"
    assert c.entry.Entry.pairs_per_request == 1 and callable(c.reference.pair)
    assert c.config["pose_tolerance_deg"] == {"rotation": 0.5, "translation": 2.0}
    fixed = harness.cell(harness.load_spec(), "ssd_pair_fixedF")
    assert c.config["pipeline"] == fixed.config["pipeline"]
    # with the pose stage replayed from CUDA graphs pairs_per_s spreads
    # 0.035-0.066 over sets of 6 seeds, latency_p95_ms 0.078: the cell
    # reports the steadier, pairs_per_s (PERF.md section 2)
    assert [m["name"] for m in c.end_to_end] == ["pairs_per_s", "setup_s"]
    assert {m["moves"] for m in c.per_layer} == {"pairs_per_s"}
    assert set(NEW_METRICS) <= {m["name"] for m in c.per_layer}
    for name in NEW_METRICS:
        assert callable(harness.metric_reader(name))


def test_program_passes_the_posed_check():
    r = run(small_posed_cell(), SEED)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["rotation_err_deg"]["value"] <= 2.0


def test_control_fails_the_posed_check():
    r = run(small_posed_cell(), SEED, control=True)
    assert not r["correct"]
    assert r["checks"]["disparity_mismatch_pct"]["value"] > 1.0


@pytest.mark.parametrize("what", ["disparity", "pose"])
def test_an_altered_answer_fails_the_posed_check(what):
    c = small_posed_cell()

    class Broken(c.entry.Entry):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            inner = self.run_pair

            def run_pair(*args, **kw):
                res = inner(*args, **kw)
                if what == "disparity":
                    res.disparity[::10] += 1.0
                else:
                    # the pose turned 5 degrees about the optical axis
                    c_, s_ = np.cos(np.radians(5.0)), np.sin(np.radians(5.0))
                    Rz = torch.tensor([[c_, -s_, 0], [s_, c_, 0], [0, 0, 1]],
                                      dtype=res.pose.pose.dtype)
                    pose = res.pose.pose.clone()
                    pose[:3, :3] = Rz @ pose[:3, :3]
                    res.pose = res.pose._replace(pose=pose)
                return res

            self.run_pair = run_pair

    r = run(c, SEED, entry=Broken)
    assert not r["correct"], r["checks"]
    if what == "pose":
        assert r["failed"] == r["attempted"]
        assert r["checks"]["rotation_err_deg"]["value"] > 3.0


def _true_F(h, w, rvec, T):
    K = np.array([[float(w), 0, w / 2], [0, float(w), h / 2], [0, 0, 1]])
    Tn = np.asarray(T, np.float64) / np.linalg.norm(T)
    return scenes.true_fundamental(K, scenes.rodrigues(np.asarray(rvec, np.float64)), Tn)


@pytest.mark.parametrize("F,shape", [
    (WITNESS_F, (750, 900)),
    (_true_F(750, 900, [0.02, -0.08, 0.01], [-1.0, 0.05, 0.15]), (750, 900)),
    (_true_F(240, 320, [0.02, -0.08, 0.01], [-1.0, 0.05, 0.15]), (240, 320)),
    (_true_F(750, 900, [-0.01, 0.03, 0.02], [-1.0, -0.1, 0.05]), (750, 900)),
], ids=["witness", "750x900", "240x320", "750x900-other"])
def test_the_reference_scaled_loop_zhang_equals_the_programs(F, shape):
    got = ref_lz_scaled.loop_zhang_homographies(F, shape, shape)
    want = prog_lz.loop_zhang_homographies(F, shape, shape)
    assert np.array_equal(got[0], want.H_left) and np.array_equal(got[1], want.H_right)
    if F is WITNESS_F:
        with pytest.raises(np.linalg.LinAlgError):
            ref_lz.loop_zhang_homographies(F, shape, shape)
    else:
        old = ref_lz.loop_zhang_homographies(F, shape, shape)
        assert np.array_equal(old[0], got[0]) and np.array_equal(old[1], got[1])


US = 1000


def _posed_request(request, t0, index0):
    """run_pair from t0 (us) with the pose stage and its five sub-spans."""
    def s(name, parent, a, b):
        return SpanRecord(name, request, -1 if parent is None else index0 + parent,
                          (t0 + a) * US, (t0 + b) * US, None)
    return [s("run_pair", None, 0, 200), s("pose", 0, 1, 150),
            s("pose.upload", 1, 2, 5), s("pose.features", 1, 5, 60),
            s("pose.match", 1, 60, 70), s("pose.ransac", 1, 70, 100),
            s("pose.ba", 1, 100, 148), s("rectify", 0, 150, 180)]


def _context(trace, window_spans=()):
    c = harness.cell(harness.load_spec(), WORKLOAD)
    return harness.Context(c, harness.Window(2, 1.0, [0.4, 0.6], list(window_spans)), 1, 0.0,
                           trace=trace, traced_requests=2, traced_seconds=1.0)


def test_new_readers_on_synthetic_spans(monkeypatch):
    records = _posed_request(0, 1000, 0) + _posed_request(1, 2000, 8)
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    dev = [kineto.Event("k", (1000 + a) * US, (1000 + a + 1) * US, True) for a in (10, 20, 30)]
    dev += [kineto.Event("k", (2000 + a) * US, (2000 + a + 2) * US, True) for a in (10, 120)]
    dev += [kineto.Event("k", 2160 * US, 2170 * US, True)]       # rectify, not pose
    dev += [kineto.Event("cudaDeviceSynchronize", t * US, (t + 1) * US, False)
            for t in (900, 2300)]                                 # the traced window
    ctx = _context(dev, [{"pose": 0.140}, {"pose": 0.150}])

    def read(name):
        return harness.metric_reader(name)(ctx)

    assert read("pose_ms") == pytest.approx(145.0)
    assert read("pose_launches") == 2.5                       # 3 and 2
    assert read("idle_pose_ms") == pytest.approx((146 + 145) / 2 / 1000)
    assert read("pose_features_ms") == pytest.approx(0.055)
    assert read("pose_ransac_ms") == pytest.approx(0.030)
    assert read("pose_ba_ms") == pytest.approx(0.048)
    monkeypatch.setattr(profiling, "dropped", lambda: 1)
    for name in ("idle_pose_ms", "pose_launches", "pose_features_ms", "pose_ransac_ms",
                 "pose_ba_ms"):
        assert read(name) is None, name


def test_pose_stage_readers_read_a_replayed_stage_on_the_device(monkeypatch):
    """A sub-span that records device time (the card's stages replayed
    from CUDA graphs) is read by that time, not by its host length."""
    records = []
    for request, t0, index0 in ((0, 1000, 0), (1, 2000, 8)):
        for r in _posed_request(request, t0, index0):
            if r.name in ("pose.ransac", "pose.ba"):
                r = r._replace(device_ms={"pose.ransac": 0.2, "pose.ba": 0.1}[r.name]
                               * (1 + request))
            records.append(r)
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    monkeypatch.setattr(profiling, "dropped", lambda: 0)
    trace = [kineto.Event("cudaDeviceSynchronize", t * US, (t + 1) * US, False)
             for t in (900, 2300)]
    ctx = _context(trace, [{"pose": 0.140}, {"pose": 0.150}])
    assert harness.metric_reader("pose_ransac_ms")(ctx) == pytest.approx(0.3)
    assert harness.metric_reader("pose_ba_ms")(ctx) == pytest.approx(0.15)
    assert harness.metric_reader("pose_features_ms")(ctx) == pytest.approx(0.055)


def test_every_new_reader_reads_a_recorded_trace():
    """A posed request recorded under a CPU profile (no device events: the
    launch count is 0 and the stage all idle)."""
    c = small_posed_cell()
    entry = c.entry.Entry(c, SEED, torch.device("cpu"))
    timings = entry.request(0, keep=False)
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            entry.request(1, keep=False)
        ctx = harness.Context(c, harness.Window(1, 1.0, [1.0], [timings]), 1, 0.0,
                              trace=kineto.events(prof), traced_requests=1,
                              traced_seconds=1.0)
        for name in NEW_METRICS:
            value = harness.metric_reader(name)(ctx)
            assert value is not None and np.isfinite(value), name
        assert harness.metric_reader("pose_launches")(ctx) == 0
    finally:
        profiling.clear()
