"""``run_batch``'s spans on the CPU: two seeded 120x160 scenes (D = 16,
block 5) under a profiler session record ``run_batch`` around the call,
and under it, in order, ``batch.upload``, ``pose`` (``pose.features`` and
the pose stage's ``pose.match``, ``pose.ransac``, ``pose.ba`` under it),
``rectify.homographies`` and ``dense`` (``rectify.warp``, ``disparity``
with a ``compute_disparity`` a pair, and the downloads, ``entry.download``,
under it). Recording moves no output bit and no ``timings`` key; nothing
is recorded without a session. On a ``data=2`` mesh each shard's wait is
a ``pose`` span of its own and each shard's dense stage a ``dense``."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stereo_reconstruction_tpu.config import MatcherConfig, PipelineConfig
from stereo_reconstruction_tpu_torch import pipeline_batch as tpb
from stereo_reconstruction_tpu_torch.config import from_jax_config
from stereo_reconstruction_tpu_torch.data.records import StereoPair
from stereo_reconstruction_tpu_torch.parallel import make_mesh
from stereo_reconstruction_tpu_torch.utils import profiling

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmark import scenes  # noqa: E402

torch.set_num_threads(1)

CONFIG = from_jax_config(PipelineConfig(matcher=MatcherConfig(block_size=5, max_disparity=16)))
TREE = [("run_batch", None), ("batch.upload", "run_batch"), ("pose", "run_batch"),
        ("pose.features", "pose"), ("pose.match", "pose"), ("pose.ransac", "pose"),
        ("pose.ba", "pose"), ("rectify.homographies", "run_batch"), ("dense", "run_batch"),
        ("rectify.warp", "dense"), ("disparity", "dense"),
        ("compute_disparity", "disparity"), ("compute_disparity", "disparity"),
        ("entry.download", "dense")]


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def pairs():
    out = []
    for k in range(2):
        left, right, K, _, _, _ = scenes.nonplanar_scene(
            np.random.default_rng(scenes.derive(23, 1, k)), 120, 160)
        out.append(StereoPair(left, right, K.astype(np.float32), K.astype(np.float32),
                              name=f"scene{k}"))
    return out


def _named(spans):
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None) for s in spans]


def _assert_same(a, b):
    np.testing.assert_array_equal(a.disparity, b.disparity)
    np.testing.assert_array_equal(a.depth, b.depth)
    np.testing.assert_array_equal(a.pose_ok, b.pose_ok)
    for x, y in zip(a.pose, b.pose):
        assert torch.equal(x, y)
    assert a.metrics == b.metrics
    assert sorted(a.timings) == sorted(b.timings)


def test_run_batch_records_its_spans_nested_in_order(pairs):
    u = tpb.batch_uniforms(CONFIG, 2)
    plain = tpb.run_batch(pairs, CONFIG, uniforms=u, device="cpu")
    assert profiling.spans() == [] and profiling.dropped() == 0
    with profile(activities=[ProfilerActivity.CPU]):
        recorded = tpb.run_batch(pairs, CONFIG, uniforms=u, device="cpu")
    _assert_same(recorded, plain)
    spans = profiling.spans()
    assert _named(spans) == TREE
    assert {s.request for s in spans} == {spans[0].request}
    by_name = {s.name: s for s in spans}
    stages = [by_name[n] for n in ("batch.upload", "pose", "rectify.homographies", "dense")]
    for a, b in zip(stages, stages[1:]):
        assert a.end_ns <= b.start_ns, (a.name, b.name)
    outer = spans[0]
    for s in spans[1:]:
        parent = spans[s.parent]
        assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns, s.name
    assert outer.start_ns <= stages[0].start_ns and stages[-1].end_ns <= outer.end_ns
    # none of the new spans is a device span: they add no CUDA event
    assert all(s.device_ms is None for s in spans)


def test_run_batch_on_a_mesh_records_a_pose_and_a_dense_span_a_shard(pairs):
    mesh = make_mesh(data=2, tile=1, devices=["cpu"] * 2)
    u = tpb.batch_uniforms(CONFIG, 2)
    plain = tpb.run_batch(pairs, CONFIG, uniforms=u, mesh=mesh)
    with profile(activities=[ProfilerActivity.CPU]):
        recorded = tpb.run_batch(pairs, CONFIG, uniforms=u, mesh=mesh)
    _assert_same(recorded, plain)
    outer = [(n, p) for n, p in _named(profiling.spans()) if p in (None, "run_batch")]
    assert outer == [("run_batch", None), ("batch.upload", "run_batch"), ("pose", "run_batch"),
                     ("rectify.homographies", "run_batch"), ("dense", "run_batch"),
                     ("pose", "run_batch"), ("rectify.homographies", "run_batch"),
                     ("dense", "run_batch")]
    # both shards' downloads run inside the last shard's dense span
    names = _named(profiling.spans())
    last_dense = max(i for i, (n, _) in enumerate(names) if n == "dense")
    assert [n for n, _ in names[last_dense:]].count("entry.download") == 2
