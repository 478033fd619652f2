"""The port's ``run_pair`` against the JAX package's on the CPU.

* The shared-pose mode, ``run_pair(fixed_F=F)``: a 48x64 synthetic plane
  scene, D=16, block 7. Rectification differs between the packages at
  float32 rounding (the inverse homography; JAX may take its band warp),
  so rectified images are not bit-equal and the matcher may flip near-tie
  pixels. Tolerances: disparity agreement >= AGREEMENT (measured 1.0, all
  3072 pixels, for both flag settings), depth rtol 1e-5 where the
  disparities agree.
* The whole chain, ``run_pair()`` with no F: the 240x320 non-planar scene
  of ``chip_smoke.nonplanar_scene`` (seed 4), D=80, block 7, with JAX's
  RANSAC draws carried across. Measured: both poses 0.117 deg (rotation)
  and 0.674 deg (translation direction) from the truth, 0.000 deg apart,
  183 inliers each; disparity agreement 0.99995. The RANSAC winner is an
  argmax over per-hypothesis inlier counts of minimal 8-point solves,
  which are ill-conditioned in float32 and differ between XLA and torch
  by rounding, so on other seeds the two can pick different winners: over
  scene seeds 0-5 at this size the poses agreed to < 0.001 deg on 2 and
  lay 0.05-1.7 deg apart on the rest, while at 750x900 (seeds 0-2) they
  agreed to 0.000 deg every time.
* The raw-pair fallback: a 64x96 pair whose rows are all equal (dyy = 0,
  so no DoG extremum passes the Hessian test and no keypoint exists),
  shifted horizontally. Both packages flag the pose invalid and match
  the raw pair; the disparities are equal.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu import config as jcfg
from stereo_reconstruction_tpu import pipeline as jpipe
from stereo_reconstruction_tpu.data.records import StereoPair as JaxStereoPair
from stereo_reconstruction_tpu_torch import pipeline as tpipe
from stereo_reconstruction_tpu_torch.config import from_jax_config
from stereo_reconstruction_tpu_torch.data.records import StereoPair
from stereo_reconstruction_tpu_torch.io.mesh_io import read_off
from stereo_reconstruction_tpu_torch.io.pfm import read_pfm

from test_torch_io import _rodrigues
from test_torch_pose import jax_uniforms

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import nonplanar_disparity, nonplanar_scene, pose_angles  # noqa: E402

torch.set_num_threads(1)

AGREEMENT = 0.995
H, W = 48, 64
JAX_CONFIG = jcfg.PipelineConfig(matcher=jcfg.MatcherConfig(block_size=7,
                                                             max_disparity=16))


def _scene(seed=0):
    """A textured plane at depth 14 seen by two cameras: the right image is
    the plane-induced homography of the left (nearest sampling, numpy);
    GT is the rectification-free pixel shift, used only by evaldisp."""
    rng = np.random.default_rng(seed)
    K = np.array([[float(W), 0, W / 2], [0, float(W), H / 2], [0, 0, 1]])
    R = _rodrigues(np.array([0.02, -0.08, 0.01]))
    T = np.array([-1.0, 0.05, 0.15])
    T /= np.linalg.norm(T)
    Tx = np.array([[0, -T[2], T[1]], [T[2], 0, -T[0]], [-T[1], T[0], 0]])
    Kinv = np.linalg.inv(K)
    F = Kinv.T @ Tx @ R @ Kinv
    F /= np.linalg.norm(F)
    H_lr = K @ (R + np.outer(T, [0.0, 0.0, 1.0]) / 14.0) @ Kinv

    left = rng.integers(10, 250, (H, W, 3)).astype(np.float64)
    for _ in range(2):
        left = (left + np.roll(left, 1, 0) + np.roll(left, 1, 1) + np.roll(left, -1, 0)) / 4
    left = left.astype(np.uint8)
    ys, xs = np.mgrid[0:H, 0:W]
    q = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)])
    p = np.linalg.solve(H_lr, q)
    px, py = np.round(p[0] / p[2]).astype(int), np.round(p[1] / p[2]).astype(int)
    inside = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    right = np.zeros_like(left).reshape(-1, 3)
    right[inside] = left[py[inside], px[inside]]
    right = right.reshape(H, W, 3)
    gt = np.where(inside, px - xs.ravel(), np.inf).reshape(H, W).astype(np.float32)
    mask = np.where(inside.reshape(H, W), 255, 0).astype(np.uint8)
    fields = dict(image_left=left, image_right=right,
                  intrinsics_left=K.astype(np.float32),
                  intrinsics_right=K.astype(np.float32),
                  disp_right_gt=gt, mask_right_nocc=mask, name="scene", ndisp=16)
    return fields, F


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _run_both(fields, F, tmp_path, **kw):
    want = jpipe.run_pair(JaxStereoPair(**fields), JAX_CONFIG, fixed_F=F,
                          output_dir=str(tmp_path / "jax"), **kw)
    got = tpipe.run_pair(StereoPair(**fields), from_jax_config(JAX_CONFIG), fixed_F=F,
                         output_dir=str(tmp_path / "torch"), device="cpu", **kw)
    return want, got


@pytest.mark.parametrize("png_compat,backwarp_compat_left", [(False, False),
                                                              (True, True)])
def test_run_pair_matches_jax(scene, tmp_path, png_compat, backwarp_compat_left):
    fields, F = scene
    want, got = _run_both(fields, F, tmp_path, png_compat=png_compat,
                          backwarp_compat_left=backwarp_compat_left)
    assert got.disparity.shape == want.disparity.shape == (H, W)
    agree = got.disparity == want.disparity
    assert agree.mean() >= AGREEMENT, f"disparity agreement {agree.mean():.4f}"
    assert np.mean(got.disparity > 0) > 0.5        # the scene is really matched
    gd, wd = got.depth[agree], want.depth[agree]
    np.testing.assert_array_equal(np.isneginf(gd), np.isneginf(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=1e-5)
    assert set(got.metrics) == set(want.metrics)
    assert got.timings.keys() == want.timings.keys()


def test_run_pair_metrics_match_jax(scene, tmp_path):
    fields, F = scene
    want, got = _run_both(fields, F, tmp_path)
    for k, v in want.metrics.items():
        assert abs(got.metrics[k] - v) <= 1e-4, k


def test_run_pair_stages_artefacts(scene, tmp_path):
    fields, F = scene
    res = tpipe.run_pair(StereoPair(**fields), from_jax_config(JAX_CONFIG),
                         output_dir=str(tmp_path), write_mesh=True, fixed_F=F,
                         device="cpu")
    np.testing.assert_array_equal(read_pfm(str(tmp_path / "scene_disp.pfm")),
                                  res.disparity)
    with open(tmp_path / "scene_pose.json") as f:
        staged = json.load(f)
    assert staged["pose"] is None
    np.testing.assert_array_equal(np.asarray(staged["fundamental"]), F)
    assert staged["metrics"] == res.metrics
    verts, cols, faces = read_off(str(tmp_path / "scene_mesh.off"))
    assert verts.shape == (H * W, 3) and cols.shape == (H * W, 4)
    assert len(faces) > 0


POSE_CONFIG = jcfg.PipelineConfig(matcher=jcfg.MatcherConfig(block_size=7,
                                                              max_disparity=80))


@pytest.fixture(scope="module")
def posed(tmp_path_factory):
    """JAX's and the port's run_pair() with no F on the non-planar scene."""
    left, right, K, R, T, F, src = nonplanar_scene(np.random.default_rng(4), 240, 320)
    gt, mask = nonplanar_disparity(src, F)
    fields = dict(image_left=left, image_right=right,
                  intrinsics_left=K.astype(np.float32),
                  intrinsics_right=K.astype(np.float32),
                  disp_right_gt=gt, mask_right_nocc=mask, name="posed", ndisp=80)
    out = tmp_path_factory.mktemp("posed")
    want = jpipe.run_pair(JaxStereoPair(**fields), POSE_CONFIG, output_dir=str(out / "jax"))
    n = POSE_CONFIG.frontend.max_keypoints
    u = jax_uniforms(POSE_CONFIG.seed, POSE_CONFIG.ransac.num_hypotheses, n)
    got = tpipe.run_pair(StereoPair(**fields), from_jax_config(POSE_CONFIG),
                         output_dir=str(out / "torch"), write_mesh=True,
                         uniforms=torch.from_numpy(u), device="cpu")
    return want, got, R, T, out / "torch"


def test_run_pair_without_F_matches_jax(posed):
    want, got, R, T, _ = posed
    assert want.metrics["pose_ok"] == got.metrics["pose_ok"] == 1.0
    assert bool(got.pose.valid) and bool(got.pose.enough_points)
    np.testing.assert_allclose(got.pose.pose.numpy()[:3, :3],
                               np.asarray(want.pose.pose)[:3, :3], atol=1e-3)
    for pose in (got.pose.pose.numpy(), want.pose.pose):
        rot, trans = pose_angles(pose, R, T)
        assert rot < 1.0 and trans < 5.0, (rot, trans)
    assert int(got.pose.num_inliers) == int(want.pose.num_inliers)
    agree = np.mean(got.disparity == want.disparity)
    assert agree >= 0.99, f"disparity agreement {agree:.4f}"
    assert set(got.metrics) == set(want.metrics)
    assert got.timings.keys() == want.timings.keys()
    for k in ("reproj_error_ba", "bad_percent", "invalid_percent"):
        assert abs(got.metrics[k] - want.metrics[k]) <= 0.01 * max(1.0, want.metrics[k]), k


def test_run_pair_without_F_stages_the_pose(posed):
    _, got, _, _, out = posed
    with open(out / "posed_pose.json") as f:
        staged = json.load(f)
    np.testing.assert_array_equal(np.asarray(staged["pose"], np.float32),
                                  got.pose.pose.numpy())
    np.testing.assert_array_equal(np.asarray(staged["fundamental"]),
                                  got.pose.fundamental.numpy().astype(np.float64))
    assert staged["metrics"] == got.metrics
    assert len(read_off(str(out / "posed_mesh.off"))[2]) > 0


def test_degenerate_pose_falls_back_to_the_raw_pair(tmp_path):
    rng = np.random.default_rng(0)
    row = rng.integers(10, 250, (1, 110, 3)).astype(np.uint8)
    left = np.repeat(row[:, :96], 64, axis=0)
    right = np.repeat(row[:, 5:101], 64, axis=0)
    K = np.array([[96.0, 0, 48], [0, 96, 32], [0, 0, 1]], np.float32)
    fields = dict(image_left=left, image_right=right, intrinsics_left=K,
                  intrinsics_right=K, name="flat")
    want = jpipe.run_pair(JaxStereoPair(**fields), JAX_CONFIG)
    got = tpipe.run_pair(StereoPair(**fields), from_jax_config(JAX_CONFIG),
                         output_dir=str(tmp_path), device="cpu")
    assert want.metrics["pose_ok"] == got.metrics["pose_ok"] == 0.0
    assert int(got.pose.num_inliers) == int(want.pose.num_inliers) == 0
    assert not bool(got.pose.valid)
    np.testing.assert_array_equal(got.disparity, want.disparity)
    with open(tmp_path / "flat_pose.json") as f:
        assert json.load(f)["fundamental"] == np.eye(3).tolist()


def test_reconstruct_from_disparity_matches_jax(scene, tmp_path):
    fields, _ = scene
    disp = np.where(np.isfinite(fields["disp_right_gt"]),
                    fields["disp_right_gt"], 0).astype(np.float32)
    cfg = dataclasses.replace(JAX_CONFIG, recon=jcfg.ReconConfig(outlier_kernel=15))
    grid_w, depth_w = jpipe.reconstruct_from_disparity(
        JaxStereoPair(**fields), disp, cfg, output_path=str(tmp_path / "j.off"))
    grid_g, depth_g = tpipe.reconstruct_from_disparity(
        StereoPair(**fields), disp, from_jax_config(cfg),
        output_path=str(tmp_path / "t.off"), device="cpu")
    np.testing.assert_array_equal(np.isneginf(depth_g), np.isneginf(depth_w))
    fin = np.isfinite(depth_w)
    np.testing.assert_allclose(depth_g[fin], depth_w[fin], rtol=1e-5)
    assert len(read_off(str(tmp_path / "t.off"))[2]) == len(
        read_off(str(tmp_path / "j.off"))[2])
