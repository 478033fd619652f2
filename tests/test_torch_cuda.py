"""K1, K1b, K2, K3, the matcher and the pose stage on the card (marker
``cuda``; skipped without a GPU).

A CUDA kernel has no CPU mode, so these run only on a machine with an
NVIDIA GPU and ``nvcc``:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

This file imports neither JAX nor the JAX package (the GPU machine has
neither). On integer-valued pairs the window sums are exact, so K1's five
planes, K2's volume and K3's disparity must equal the plain twins' bit for
bit. K1 and K2 add in the same order, so K2's reductions equal K1's planes
on any input. K1b (the exact row scan) equals its plain twin bit for bit
on any planes. The pose stage is plain PyTorch; on the card it must give
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
from stereo_reconstruction_tpu_torch.ops import cuda_row_scan as crs
from stereo_reconstruction_tpu_torch.ops.block_search import block_search_right
from stereo_reconstruction_tpu_torch.ops.cost_volume import black_pixel_mask
from stereo_reconstruction_tpu_torch.ops.smoothing import (
    smoothed_argmin_from_inputs,
    volume_reductions,
)
from stereo_reconstruction_tpu_torch.pipeline import estimate_pose, run_pair

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import (  # noqa: E402
    _random_stereo,
    nonplanar_scene,
    pose_angles,
    scan_volume,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1, K1b, K2, K3 are CUDA kernels with no CPU mode")
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
    (120, 200, 5, 17, 1, 30),     # interior tiles (no masked dsq)
    (1, 40, 0, 5, 0, 8),          # one row: every window empty
    # an interior tile whose band ends at row H-2, at the block sizes whose
    # phase-A1 slots overrun the band (by 3, 4, 2, 2 rows): the last slot
    # must not load below the image
    (99, 200, 0, 5, 0, 20),
    (101, 200, 0, 9, 1, 30),
    (102, 200, 0, 11, 0, 20),
    (104, 200, 0, 15, 0, 20),
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


@pytest.mark.parametrize("h,w,bs", [(33, 150, 9), (120, 200, 17)])
def test_k2_reductions_equal_k1_on_non_integer_pair(cuda, rng, h, w, bs):
    left = rng.uniform(0.0, 255.0, (h, w, 3)).astype(np.float32)
    right = np.roll(left, -5, axis=1) + rng.normal(0.0, 3.0, left.shape).astype(np.float32)
    args = (torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda), bs, 1, 40)
    got = volume_reductions(ccv.cost_volume(*args), 1)
    want = ccv.matcher_inputs(*args)
    for name, g, wv in zip(("m0", "a0", "c_zero", "diag_up", "diag_lf"), got, want):
        assert g.dtype == wv.dtype and torch.equal(g, wv), name


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_k1_refuses_blocks_above_17(cuda, rng, kernel):
    """K1, K2 and K3 share the window-cost routine (hbs <= 8)."""
    left, right = _integer_pair(rng, 21, 40)
    L, R = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    call = {"K1": lambda: ccv.matcher_inputs(L, R, 19, 0, 8),
            "K2": lambda: ccv.cost_volume(L, R, 19, 0, 8),
            "K3": lambda: cbs.block_search_fused(
                L, R, MatcherConfig(block_size=19, max_disparity=8))}[kernel]
    with pytest.raises(ValueError, match=f"{kernel} takes block sizes up to 17"):
        call()


@pytest.mark.parametrize("h,w,d_first,sf,ties", [
    (9, 1, 0, 0.9, False),
    (9, 33, 2, 0.9, False),
    (7, 100, 0, 1.0, True),
    (5, 1100, 0, 0.9, False),       # 2 columns per thread
    (5, 1100, 2, 0.5, True),
    (4, 2100, 0, 0.9, False),       # 3 columns per thread
    (3, 4096, 1, 0.9, True),        # the widest row: 4 columns per thread
    (6, 70, 0, 0.0, False),         # inf * 0 = NaN compares false
])
def test_k1b_bit_equal_to_plain_on_random_planes(cuda, h, w, d_first, sf, ties):
    cost, black = scan_volume(np.random.default_rng(w + d_first), h, w, 12, ties)
    planes = volume_reductions(torch.from_numpy(cost).to(cuda), d_first)
    black = torch.from_numpy(black).to(cuda)
    kw = dict(smooth_factor=sf, d_first=d_first, n_planes=12)
    got = crs.row_scan(*planes, black, **kw)
    want = smoothed_argmin_from_inputs(*planes, black, **kw)
    assert got.device.type == "cuda" and torch.equal(got, want)


def test_k1b_bit_equal_to_plain_on_k1_planes(cuda, rng):
    left, right = _integer_pair(rng, 70, 130)
    L, R = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    planes = ccv.matcher_inputs(L, R, 7, 0, 30)
    black = black_pixel_mask(R.float())
    got = crs.row_scan(*planes, black, n_planes=30)
    want = smoothed_argmin_from_inputs(*planes, black, n_planes=30)
    assert torch.equal(got, want)


def test_k1b_wrapper_checks_and_counts(cuda):
    cost, black = scan_volume(np.random.default_rng(0), 4, 40, 8)
    planes = volume_reductions(torch.from_numpy(cost).to(cuda), 0)
    black = torch.from_numpy(black).to(cuda)
    before = crs.LAUNCHES
    crs.row_scan(*planes, black, n_planes=8)
    assert crs.LAUNCHES == before + 1
    smoothed_argmin_from_inputs(*planes, black, n_planes=8)
    assert crs.LAUNCHES == before + 1
    with pytest.raises(ValueError, match="int32"):
        crs.row_scan(planes[0], planes[1].long(), *planes[2:], black, n_planes=8)
    assert crs.max_width() == 4096
    wide = torch.zeros((2, crs.max_width() + 1), device=cuda)
    with pytest.raises(ValueError, match="W <="):
        crs.row_scan(wide, wide.int(), wide, wide, wide, wide.bool(), n_planes=8)
    with pytest.raises(ValueError, match="contiguous"):
        crs.row_scan(*(p.t().contiguous().t() for p in planes), black, n_planes=8)


@pytest.mark.parametrize("h,w,wl_extra,bs,min_d,max_d,tw,iters,mode", [
    (28, 40, 0, 7, 0, 10, 128, 2, "reference"),      # 1 tile
    (20, 80, 0, 5, 0, 8, 40, 2, "reference"),        # 2 tiles
    (20, 90, 0, 5, 0, 8, 64, 1, "reference"),        # W not a multiple of TW
    (20, 90, 0, 5, 0, 8, 64, 3, "reference"),
    (20, 90, 0, 5, 0, 8, 64, 2, "intended"),
    (20, 90, 0, 5, 0, 8, 64, 2, "none"),
    (21, 40, 9, 5, 2, 12, 512, 2, "reference"),      # min_d 2, wider left
    (40, 1100, 0, 17, 0, 48, 512, 3, "intended"),    # 3 tiles of 512
    (20, 90, 0, 5, 0, 8, 2, 3, "intended"),          # tiles narrower than iters
    (101, 200, 0, 9, 1, 31, 64, 2, "reference"),     # (d): band ends at row H-2
    (8, 4200, 0, 5, 0, 16, 1024, 2, "reference"),    # wider than 4096
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


@pytest.mark.parametrize("seed,mode", [(0, "intended"), (1, "intended"), (2, "intended"),
                                       (0, "reference")])
def test_k3_nan_rule_at_zero_smooth_factor(cuda, seed, mode):
    """+inf * 0 is NaN; a NaN wins the minimum, so the column takes -x
    (the twin equals JAX there: tests/test_torch_fused_search.py)."""
    left, right = _random_stereo(np.random.default_rng(seed), 20, 40, max_d=8)
    L, R = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    cfg = MatcherConfig(block_size=5, max_disparity=30, smooth_factor=0.0,
                        row_smooth_iters=2)
    got = cbs.block_search_fused(L, R, cfg, 64, mode)
    assert torch.equal(got, cbs.block_search_fused_plain(L, R, cfg, 64, mode))
    if mode == "intended":
        assert (got[:, 37] == -37).all()


def test_k3_is_deterministic_on_non_integer_pair(cuda, rng):
    left = rng.uniform(0.0, 255.0, (200, 700, 3)).astype(np.float32)
    right = np.roll(left, -9, axis=1) + rng.normal(0.0, 3.0, left.shape).astype(np.float32)
    L, R = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    cfg = MatcherConfig(block_size=17, max_disparity=64)
    first = cbs.block_search_fused(L, R, cfg, 256)
    assert torch.equal(first, cbs.block_search_fused(L, R, cfg, 256))
    # the window sums round apart from the twin's on non-integer inputs
    assert (first == cbs.block_search_fused_plain(L, R, cfg, 256)).double().mean() >= 0.995


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


def _launches():
    return (ccv.LAUNCHES, crs.LAUNCHES, ccv.VOLUME_LAUNCHES, cbs.LAUNCHES)


def test_run_pair_without_F_launches_k1_once(cuda):
    pair, _, _ = _posed_pair()
    cfg = PipelineConfig(matcher=MatcherConfig(block_size=7, max_disparity=80))
    before = _launches()
    res = run_pair(pair, cfg, device=cuda)
    assert _launches() == (before[0] + 1, before[1] + 1, before[2], before[3])
    assert res.metrics["pose_ok"] == 1.0
    assert res.disparity.shape == (240, 320) and np.mean(res.disparity > 0) > 0.5


def test_run_pair_with_F_launches_k1_and_k1b_once(cuda):
    left, right, K, _, _, F, _ = nonplanar_scene(np.random.default_rng(4), 240, 320)
    pair = StereoPair(left, right, K.astype(np.float32), K.astype(np.float32), name="F")
    cfg = PipelineConfig(matcher=MatcherConfig(block_size=7, max_disparity=80))
    before = _launches()
    res = run_pair(pair, cfg, fixed_F=F, device=cuda)
    assert _launches() == (before[0] + 1, before[1] + 1, before[2], before[3])
    plain = run_pair(pair, cfg.replace(matcher=MatcherConfig(block_size=7, max_disparity=80,
                                                             backend="xla")),
                     fixed_F=F, device=cuda)
    # the rectified canvas is not integer-valued, so the two backends' window
    # sums may round apart on near-tie pixels (chip_smoke holds 99.5%)
    assert np.mean(res.disparity == plain.disparity) >= 0.995
