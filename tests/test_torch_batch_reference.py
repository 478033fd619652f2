"""``run_batch`` against the plain reference of the batched posed cell
(``benchmark/configs/ssd_batch8_posed_750x900_d200.py``, loaded from its
file as the benchmark's harness loads it) on the CPU: three seeded
240x320 scenes, D = 16, block 5, padded to 240x384 (a 360x576 canvas).
The reference is given each pair's own F, the one the program's pose
found, and the batch's largest image shape.

Held, each with its reason:

* the pose of every pair within the configuration's 0.5 / 2 degrees of the
  truth, ``pose_ok`` set (measured worst 0.224 / 0.875 degrees);
* disparity on the padded frame equal to the reference's on all but
  0.01% of the pixels (9 of 92,160): the program casts the homographies
  to float32 and maps coordinates in float32, the reference keeps
  float64, so a bilinear sample a rounding apart can flip a near tie of
  the argmin (measured 1, 3 and 2 pixels);
* depth within 1e-3 relative of the reference's on all but 0.01% of the
  pixels, the pixels whose disparity flipped (measured 0, 2 and 1);
* a pair whose pose failed (the flat-row pair of ``chip_smoke.flat_pair``,
  which has no keypoints) is warped with identity homographies by both,
  and agrees pixel for pixel: identity maps land on whole pixels in
  either precision;
* a pair given a wrong F differs from the program's on far more (the
  comparison can fail).
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu_torch import pipeline_batch as tpb
from stereo_reconstruction_tpu_torch.config import from_jax_config
from stereo_reconstruction_tpu_torch.data.records import StereoPair

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from benchmark import scenes  # noqa: E402
from benchmark.entries.run_pair import mismatch_pct, pose_angles  # noqa: E402

torch.set_num_threads(1)

CONFIG_FILE = os.path.join(ROOT, "benchmark", "configs", "ssd_batch8_posed_750x900_d200")
H, W = 240, 320
ROTATION_DEG, TRANSLATION_DEG = 0.5, 2.0
MISMATCH_PCT = 0.01


def _load_reference():
    spec = importlib.util.spec_from_file_location("batch_reference", CONFIG_FILE + ".py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def case():
    with open(CONFIG_FILE + ".json") as f:
        pipeline = json.load(f)["pipeline"]
    pipeline["matcher"].update(block_size=5, max_disparity=16)
    scenes_ = [scenes.nonplanar_scene(np.random.default_rng(scenes.derive(11, 1, k)), H, W)
               for k in range(3)]
    pairs = [StereoPair(left, right, K.astype(np.float32), K.astype(np.float32))
             for left, right, K, _, _, _ in scenes_]
    res = tpb.run_batch(pairs, from_jax_config(pipeline), device="cpu")
    return pipeline, scenes_, res, _load_reference()


def test_every_batched_pose_is_held_to_its_truth(case):
    _, scenes_, res, _ = case
    assert res.pose_ok.all()
    for k, (_, _, _, R, T, _) in enumerate(scenes_):
        rot, tr = pose_angles(res.pose.pose[k].numpy(), R, T)
        assert rot <= ROTATION_DEG and tr <= TRANSLATION_DEG, (k, rot, tr)


@pytest.mark.parametrize("k", range(3))
def test_run_batch_agrees_with_the_padded_canvas_reference(case, k):
    pipeline, scenes_, res, ref = case
    left, right, K = scenes_[k][:3]
    F = res.pose.fundamental[k].numpy().astype(np.float64)
    disp, depth = ref.pair(left, right, K, F, pipeline, "cpu", (H, W))
    assert disp.shape == res.disparity[k].shape == (240, 384)
    assert mismatch_pct(res.disparity[k], disp) <= MISMATCH_PCT
    assert mismatch_pct(res.depth[k], depth, rtol=1e-3) <= MISMATCH_PCT


def test_a_failed_pose_is_warped_with_identity_by_both(case):
    from chip_smoke import flat_pair

    pipeline, scenes_, _, ref = case
    left, right, K = scenes_[0][:3]
    flat_l, flat_r = flat_pair(H, W)
    pairs = [StereoPair(left, right, K.astype(np.float32), K.astype(np.float32)),
             StereoPair(flat_l, flat_r, K.astype(np.float32), K.astype(np.float32))]
    res = tpb.run_batch(pairs, from_jax_config(pipeline), device="cpu")
    assert res.pose_ok.tolist() == [True, False]
    disp, depth = ref.pair(flat_l, flat_r, K, None, pipeline, "cpu", (H, W))
    np.testing.assert_array_equal(res.disparity[1], disp)
    np.testing.assert_array_equal(res.depth[1], depth)


def test_the_reference_tells_a_wrong_F_apart(case):
    pipeline, scenes_, res, ref = case
    left, right, K = scenes_[0][:3]
    F = res.pose.fundamental[1].numpy().astype(np.float64)
    F = F + np.diag([0.0, 0.0, 0.05]) * np.abs(F).max()
    disp, _ = ref.pair(left, right, K, F, pipeline, "cpu", (H, W))
    assert mismatch_pct(res.disparity[0], disp) > 1.0
