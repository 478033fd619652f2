"""The port's span recorder (``utils/profiling.py``) on the CPU.

Recording is on exactly while a ``torch.profiler`` session is active: no
span is kept without one, and ``run_pair``'s ``timings`` (host clock
around each stage) are filled either way. Under a CPU profile,
``run_pair(fixed_F=F)`` records its stage tree as one request, every
span on the profile's own clock: the aten ops each span issued lie
inside it. The perceptual search records one tower and one distance span
a row block; a full buffer counts the spans it refused.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stereo_reconstruction_tpu_torch import pipeline as tpipe
from stereo_reconstruction_tpu_torch.config import from_jax_config
from stereo_reconstruction_tpu_torch.data.records import StereoPair
from stereo_reconstruction_tpu_torch.perceptual import vgg as tvgg
from stereo_reconstruction_tpu_torch.utils import profiling

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))
from chip_smoke import narrow_vgg_params, perceptual_pair  # noqa: E402
from test_torch_pipeline import JAX_CONFIG, _scene  # noqa: E402

torch.set_num_threads(1)

# run_pair's spans: (name, parent's name) in the order they open
RUN_PAIR_TREE = [
    ("run_pair", None),
    ("pose", "run_pair"),
    ("rectify", "run_pair"),
    ("rectify.upload", "rectify"),
    ("rectify.homographies", "rectify"),
    ("rectify.warp", "rectify"),
    ("disparity", "run_pair"),
    ("compute_disparity", "disparity"),
    ("entry.download", "run_pair"),
    ("recon", "run_pair"),
    ("recon.upload", "recon"),
    ("recon.upload", "recon"),
    ("entry.download", "run_pair"),
]


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def fixed_pair():
    fields, F = _scene()
    return StereoPair(**fields), F, from_jax_config(JAX_CONFIG)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_recording_off_keeps_nothing_and_timings(fixed_pair):
    pair, F, config = fixed_pair
    res = tpipe.run_pair(pair, config, fixed_F=F, device="cpu")
    assert profiling.spans() == [] and profiling.dropped() == 0
    # the JAX package's keys (tests/test_torch_pipeline.py holds them equal)
    assert list(res.timings) == ["pose", "rectify", "disparity", "recon"]
    assert all(v >= 0 for v in res.timings.values())


def test_run_pair_records_its_span_tree_as_one_request(fixed_pair):
    pair, F, config = fixed_pair
    with _cpu_profile():
        res = tpipe.run_pair(pair, config, fixed_F=F, device="cpu")
    spans = profiling.spans()
    assert [(s.name, spans[s.parent].name if s.parent >= 0 else None)
            for s in spans] == RUN_PAIR_TREE
    assert {s.request for s in spans} == {spans[0].request}
    for s in spans:
        assert s.start_ns <= s.end_ns and s.device_ms is None
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, s.name
    # the stage spans are the timings' stages
    by_name = {s.name: (s.end_ns - s.start_ns) / 1e9 for s in spans}
    for stage in ("rectify", "disparity", "recon"):
        assert by_name[stage] <= res.timings[stage]


def test_spans_contain_the_ops_they_issued_on_the_profiles_clock(fixed_pair):
    """Each span's profiler range (opened inside the span) holds the aten
    ops the span issued; those ops lie inside the span as recorded, so
    the two clocks agree to well under an op's length."""
    pair, F, config = fixed_pair
    with _cpu_profile() as prof:
        tpipe.run_pair(pair, config, fixed_F=F, device="cpu")
    spans = profiling.spans()
    events = list(prof.profiler.kineto_results.events())
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in events if e.name().startswith("aten::")]
    checked = 0
    for name in {s.name for s in spans}:
        ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                        for e in events if e.name() == name)
        mine = [s for s in spans if s.name == name]
        assert len(ranges) == len(mine), name
        for (r0, r1), s in zip(ranges, mine):
            inner = [(a, b) for a, b in ops if r0 <= a and b <= r1]
            assert all(s.start_ns <= a and b <= s.end_ns for a, b in inner), name
            checked += len(inner)
    assert checked > 100


def test_perceptual_search_records_tower_and_distance_per_row_block(tmp_path):
    path = str(tmp_path / "narrow.npz")
    tvgg.save_params_npz(path, narrow_vgg_params())
    config = from_jax_config(JAX_CONFIG)
    config = dataclasses.replace(
        config,
        matcher=dataclasses.replace(config.matcher, cost="perceptual", max_disparity=6),
        perceptual=dataclasses.replace(config.perceptual, weights_path=path, row_block=4))
    left, right = (torch.as_tensor(a) for a in perceptual_pair(np.random.default_rng(3), 10, 24))
    with _cpu_profile():
        disparity = tpipe.compute_disparity(left, right, config)
    assert disparity.shape == (10, 24)
    spans = profiling.spans()
    assert [s.name for s in spans] == (
        ["compute_disparity"] + ["perceptual.tower", "perceptual.distance"] * 3)
    assert all(s.parent == 0 and s.request == spans[0].request for s in spans[1:])
    assert all(s.device_ms is None for s in spans)      # no CUDA events on the CPU


def test_full_buffer_counts_dropped(monkeypatch):
    monkeypatch.setattr(profiling._RECORDER, "capacity", 3)
    with _cpu_profile():
        with profiling.span("a"):
            for _ in range(4):
                with profiling.span("b"):
                    pass
        with profiling.span("c"):
            pass
    assert [s.name for s in profiling.spans()] == ["a", "b", "b"]
    assert profiling.dropped() == 3
    assert len({s.request for s in profiling.spans()}) == 1
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0
