"""K1, K2, K3, the matcher and the pose stage on the card (marker ``cuda``;
skipped without a GPU).

A CUDA kernel has no CPU mode, so these run only on a machine with an
NVIDIA GPU and ``nvcc``:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

This file imports neither JAX nor the JAX package (the GPU machine has
neither). On integer-valued pairs the window sums are exact, so K1's five
planes, K2's volume and K3's disparity must equal the plain twins' bit for
bit. K1 and K2 share their cost code, so K2's reductions equal K1's planes
on any input. The pose stage is plain PyTorch; on the card it must give
the port's CPU pose for the same RANSAC draws.
"""

import os
import sys

import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu_torch.config import MatcherConfig, PipelineConfig
from stereo_reconstruction_tpu_torch.data.records import StereoPair
from stereo_reconstruction_tpu_torch.ops import cuda_block_search as cbs
from stereo_reconstruction_tpu_torch.ops import cuda_cost_volume as ccv
from stereo_reconstruction_tpu_torch.ops.block_search import block_search_right
from stereo_reconstruction_tpu_torch.ops.smoothing import volume_reductions
from stereo_reconstruction_tpu_torch.pipeline import estimate_pose, run_pair

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import nonplanar_scene, pose_angles  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1-K3 are CUDA kernels with no CPU mode")
    return torch.device("cuda")


def _integer_pair(rng, h, w, wl_extra=0):
    left = rng.integers(10, 250, (h, w, 3)).astype(np.float64)
    for _ in range(2):
        left = (left + np.roll(left, 1, 0) + np.roll(left, 1, 1) + np.roll(left, -1, 0)) / 4
    left = left.astype(np.uint8)
    shift = np.round(4 + 3 * np.sin(np.arange(w) / 7)).astype(int)
    right = left[:, np.clip(np.arange(w) + shift, 0, w - 1)]
    right = np.clip(right.astype(np.int64) + rng.integers(-6, 6, right.shape),
                    1, 255).astype(np.uint8)
    right[:, :2] = 0
    return np.pad(left, ((0, 0), (0, wl_extra), (0, 0))), right


K1_CASES = [
    (21, 40, 9, 5, 2, 12),
    (37, 150, 0, 17, 0, 40),
    (19, 70, 30, 17, 3, 100),     # planes beyond every candidate
    (20, 70, 0, 1, 0, 16),        # empty window: every plane +inf
]


@pytest.mark.parametrize("h,w,wl_extra,bs,min_d,max_d", K1_CASES)
def test_k1_planes_bit_equal_to_plain(cuda, rng, h, w, wl_extra, bs, min_d, max_d):
    left, right = _integer_pair(rng, h, w, wl_extra)
    args = (torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda),
            bs, min_d, max_d)
    got = ccv.matcher_inputs(*args)
    want = ccv.matcher_inputs_plain(*args)
    for name, g, wv in zip(("m0", "a0", "c_zero", "diag_up", "diag_lf"), got, want):
        assert g.dtype == wv.dtype and torch.equal(g, wv), name


def test_wrapper_counts_each_launch(cuda, rng):
    left, right = _integer_pair(rng, 21, 40)
    before = ccv.LAUNCHES
    ccv.matcher_inputs(torch.from_numpy(left).to(cuda),
                       torch.from_numpy(right).to(cuda), 5, 0, 8)
    assert ccv.LAUNCHES == before + 1
    ccv.matcher_inputs_plain(torch.from_numpy(left).to(cuda),
                             torch.from_numpy(right).to(cuda), 5, 0, 8)
    assert ccv.LAUNCHES == before + 1


def test_block_search_kernel_equals_plain(cuda, rng):
    left, right = _integer_pair(rng, 28, 40)
    L, R = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    cfg = MatcherConfig(block_size=7, max_disparity=10)
    got = block_search_right(L, R, cfg)                       # "auto": K1
    want = block_search_right(L, R, MatcherConfig(block_size=7, max_disparity=10,
                                                  backend="xla"))
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w,wl_extra,bs,min_d,max_d", K1_CASES)
def test_k2_volume_bit_equal_to_plain(cuda, rng, h, w, wl_extra, bs, min_d, max_d):
    left, right = _integer_pair(rng, h, w, wl_extra)
    args = (torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda),
            bs, min_d, max_d)
    got = ccv.cost_volume(*args)
    want = ccv.cost_volume_right_ssd(*args)
    assert got.shape == (max_d - min_d, h, w)
    assert torch.equal(got, want)          # +inf pattern included


def test_k2_reductions_equal_k1_on_non_integer_pair(cuda, rng):
    left = rng.uniform(0.0, 255.0, (33, 150, 3)).astype(np.float32)
    right = np.roll(left, -5, axis=1) + rng.normal(0.0, 3.0, left.shape).astype(np.float32)
    args = (torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda), 9, 1, 40)
    got = volume_reductions(ccv.cost_volume(*args), 1)
    want = ccv.matcher_inputs(*args)
    for name, g, wv in zip(("m0", "a0", "c_zero", "diag_up", "diag_lf"), got, want):
        assert g.dtype == wv.dtype and torch.equal(g, wv), name


@pytest.mark.parametrize("h,w,wl_extra,bs,min_d,max_d,tw,iters,mode", [
    (28, 40, 0, 7, 0, 10, 128, 2, "reference"),      # 1 tile
    (20, 80, 0, 5, 0, 8, 40, 2, "reference"),        # 2 tiles
    (20, 90, 0, 5, 0, 8, 64, 1, "reference"),        # W not a multiple of TW
    (20, 90, 0, 5, 0, 8, 64, 3, "reference"),
    (20, 90, 0, 5, 0, 8, 64, 2, "intended"),
    (20, 90, 0, 5, 0, 8, 64, 2, "none"),
    (21, 40, 9, 5, 2, 12, 512, 2, "reference"),      # min_d 2, wider left
    (40, 1100, 0, 17, 0, 48, 512, 3, "intended"),    # 3 tiles of 512
])
def test_k3_bit_equal_to_plain(cuda, rng, h, w, wl_extra, bs, min_d, max_d, tw,
                               iters, mode):
    left, right = _integer_pair(rng, h, w, wl_extra)
    L, R = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    cfg = MatcherConfig(block_size=bs, min_disparity=min_d, max_disparity=max_d,
                        row_smooth_iters=iters)
    got = cbs.block_search_fused(L, R, cfg, tw, mode)
    want = cbs.block_search_fused_plain(L, R, cfg, tw, mode)
    assert torch.equal(got, want)


def test_k2_and_k3_wrappers_count_each_launch(cuda, rng):
    left, right = _integer_pair(rng, 21, 40)
    L, R = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    before = (ccv.LAUNCHES, ccv.VOLUME_LAUNCHES, cbs.LAUNCHES)
    ccv.cost_volume(L, R, 5, 0, 8)
    assert (ccv.LAUNCHES, ccv.VOLUME_LAUNCHES, cbs.LAUNCHES) == (
        before[0], before[1] + 1, before[2])
    cfg = MatcherConfig(block_size=5, max_disparity=8)
    cbs.block_search_fused(L, R, cfg)
    assert (ccv.LAUNCHES, ccv.VOLUME_LAUNCHES, cbs.LAUNCHES) == (
        before[0], before[1] + 1, before[2] + 1)
    ccv.cost_volume_right_ssd(L, R, 5, 0, 8)
    cbs.block_search_fused_plain(L, R, cfg)
    assert (ccv.LAUNCHES, ccv.VOLUME_LAUNCHES, cbs.LAUNCHES) == (
        before[0], before[1] + 1, before[2] + 1)


def _posed_pair():
    left, right, K, R, T, _, _ = nonplanar_scene(np.random.default_rng(4), 240, 320)
    K = K.astype(np.float32)
    return StereoPair(left, right, K, K, name="posed"), R, T


def test_pose_stage_on_card_matches_cpu(cuda):
    pair, R, T = _posed_pair()
    cfg = PipelineConfig()
    got = estimate_pose(pair, cfg, device=cuda)
    want = estimate_pose(pair, cfg, device="cpu")
    assert got.pose.device.type == "cuda" and got.fundamental.device.type == "cuda"
    assert bool(got.valid) and bool(want.valid)
    # the 2 * mean outlier filter may keep a few matches more or fewer when
    # the RANSAC poses differ by rounding (157 and 164 on the H100)
    np.testing.assert_allclose(got.pose.cpu().numpy()[:3, :3], want.pose.numpy()[:3, :3],
                               atol=1e-3)
    rot, trans = pose_angles(got.pose.cpu().numpy(), R, T)
    assert rot < 1.0 and trans < 5.0


def test_run_pair_without_F_launches_k1_once(cuda):
    pair, _, _ = _posed_pair()
    cfg = PipelineConfig(matcher=MatcherConfig(block_size=7, max_disparity=80))
    before = (ccv.LAUNCHES, ccv.VOLUME_LAUNCHES, cbs.LAUNCHES)
    res = run_pair(pair, cfg, device=cuda)
    assert (ccv.LAUNCHES, ccv.VOLUME_LAUNCHES, cbs.LAUNCHES) == (
        before[0] + 1, before[1], before[2])
    assert res.metrics["pose_ok"] == 1.0
    assert res.disparity.shape == (240, 320) and np.mean(res.disparity > 0) > 0.5
