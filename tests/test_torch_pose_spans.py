"""The pose stage's sub-spans (``pose.upload``, ``pose.features``,
``pose.match``, ``pose.ransac``, ``pose.ba``) on the CPU: children of
``run_pair``'s ``pose`` stage in that order and inside it while a
profiler session is active; nothing recorded without one; and
``run_batch``, whose pose runs ``pose_from_keypoints`` under
``torch.func.vmap``, runs under an active recorder."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stereo_reconstruction_tpu.config import MatcherConfig, PipelineConfig
from stereo_reconstruction_tpu_torch import pipeline as tpipe
from stereo_reconstruction_tpu_torch import pipeline_batch as tpb
from stereo_reconstruction_tpu_torch.config import from_jax_config
from stereo_reconstruction_tpu_torch.data.records import StereoPair
from stereo_reconstruction_tpu_torch.utils import profiling

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import nonplanar_scene  # noqa: E402

torch.set_num_threads(1)

CONFIG = from_jax_config(PipelineConfig(matcher=MatcherConfig(block_size=5, max_disparity=16)))
POSE_TREE = [("pose", "run_pair"), ("pose.upload", "pose"), ("pose.features", "pose"),
             ("pose.match", "pose"), ("pose.ransac", "pose"), ("pose.ba", "pose")]


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def posed_pair():
    left, right, K, _, _, _, _ = nonplanar_scene(np.random.default_rng(4), 240, 320)
    K = K.astype(np.float32)
    return StereoPair(left, right, K, K, name="posed")


def _named(spans):
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None) for s in spans]


def test_posed_run_pair_records_the_pose_sub_spans_in_order(posed_pair):
    with profile(activities=[ProfilerActivity.CPU]):
        res = tpipe.run_pair(posed_pair, CONFIG, device="cpu")
    assert res.metrics["pose_ok"] == 1.0
    spans = profiling.spans()
    assert _named(spans)[1:7] == POSE_TREE
    pose = spans[1]
    subs = spans[2:7]
    for a, b in zip(subs, subs[1:]):
        assert a.end_ns <= b.start_ns, (a.name, b.name)
    assert pose.start_ns <= subs[0].start_ns and subs[-1].end_ns <= pose.end_ns
    assert {s.request for s in spans} == {spans[0].request}
    # no sub-span is a device span: they add no CUDA event
    assert all(s.device_ms is None for s in subs)
    assert [n for n, _ in _named(spans)].count("pose.ba") == 1


def test_pose_sub_spans_record_nothing_without_a_profiler(posed_pair):
    tpipe.estimate_pose(posed_pair, CONFIG, device="cpu")
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_run_batch_runs_under_an_active_recorder(posed_pair):
    u = tpb.batch_uniforms(CONFIG, 1)
    plain = tpb.run_batch([posed_pair], CONFIG, uniforms=u, device="cpu")
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        recorded = tpb.run_batch([posed_pair], CONFIG, uniforms=u, device="cpu")
    names = [s.name for s in profiling.spans()]
    # the vmapped body runs once for the batch
    assert [n for n in names if n.startswith("pose.")] == ["pose.match", "pose.ransac",
                                                            "pose.ba"]
    assert torch.equal(recorded.pose.pose, plain.pose.pose)
    np.testing.assert_array_equal(recorded.disparity, plain.disparity)
