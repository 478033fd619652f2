"""K1, K1b, K2, K3, the matcher, the pose stage and ``run_batch`` on the
card (marker ``cuda``; skipped without a GPU).

A CUDA kernel has no CPU mode, so these run only on a machine with an
NVIDIA GPU and ``nvcc``:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

This file imports neither JAX nor the JAX package (the GPU machine has
neither). On integer-valued pairs the window sums are exact, so K1's five
planes, K2's volume and K3's disparity must equal the plain twins' bit for
bit. K1 and K2 add in the same order, so K2's reductions equal K1's planes
on any input. K1b (the exact row scan) equals its plain twin bit for bit
on any planes. The pose stage is plain PyTorch; on the card it must give
the port's CPU pose for the same RANSAC draws, and its stages after SIFT,
replayed from CUDA graphs with no host synchronisation, equal the eager
stages bit for bit. ``run_batch`` launches one
K1 and one K1b per pair, agrees >= 99.5% with its plain backend, and masks
a pair whose pose fails without moving its neighbours past 0.5%. The dense
variants (SAD, NCC, the variable block) launch K1b once on the plain
volume's planes and equal the plain scan there; they, the Left variant and
the linear search agree with the port on the CPU; ``run_uncalibrated``
meets its gates on the card for every detector. K4 (the perceptual
matcher's windowed smoother) equals its plain twin bit for bit on planted
volumes, refuses what it does not take with a ``ValueError``, and the
windowed search on the card agrees with the port on the CPU (narrow VGG
widths: 100% within 2 px, >= 98% exact) with one K4 launch. K1 and K2 in
global-row mode (a halo-extended row tile of a taller image) equal their
twins bit for bit and, on the rows whose window the tile holds, the whole
image's; K1b seeded (``first_flags``, ``init_prev``) equals its twin, and
seeded tiles chain to one launch; K1b equals its twin on chain planes
(``torch_helpers.chain_planes``) at widths around its strip and cluster
boundaries up to its widest row (8192), plain and seeded, and a row wider
than 4096 goes through K1 and K1b in ``block_search_right``; the exact sharded matcher on a
``cuda:0`` x 8 mesh equals ``block_search_right`` with 8 K1 and 32 K1b
launches. The warp kernel equals its plain twin (``warp_inverse_map``
on the card) bit for bit on random maps, -0.0 and batches of two launches
included, and takes what the twin takes (other dtypes, views, 2 and 4
channels); the rectifying warps and the back-warp make no host
synchronisation, equal the CPU path bit for bit, and launch it twice a
fixed-F ``run_pair`` (never in a perceptual ``compute_disparity``). The
RANSAC kernel on the card equals its twin (``ransac_plain`` with its
rounding pinned to the kernel's, ``ransac_twin.py``, on the CPU) to that
file's limits, past the matches whose refit keys shared memory holds too,
launches twice a posed ``run_pair`` (never a fixed-F one) and twice a
``run_batch`` of four posed pairs, each of whose poses is within 1e-3 of
its ``run_pair``, and from it the two benchmark fixtures pose within 0.5 /
2 degrees.
"""

import os
import sys

import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu_torch.config import MatcherConfig, PipelineConfig
from stereo_reconstruction_tpu_torch.data.records import StereoPair, pad_to
from stereo_reconstruction_tpu_torch.kernels.launch import LAUNCHES
from stereo_reconstruction_tpu_torch.ops import cuda_block_search as cbs
from stereo_reconstruction_tpu_torch.ops import cuda_cost_volume as ccv
from stereo_reconstruction_tpu_torch.ops import cuda_row_scan as crs
from stereo_reconstruction_tpu_torch.ops import cuda_ransac, cuda_warp
from stereo_reconstruction_tpu_torch.ops import cost_volume as tcv
from stereo_reconstruction_tpu_torch.ops.block_search import block_search_left, block_search_right
from stereo_reconstruction_tpu_torch.ops.linear_search import linear_search
from stereo_reconstruction_tpu_torch.ops.cost_volume import black_pixel_mask
from stereo_reconstruction_tpu_torch.ops.warp import warp_inverse_map, warp_inverse_maps, \
    warp_perspective
from stereo_reconstruction_tpu_torch.rectify.rectifier import (
    disparity_to_original_frame,
    rectify_pair,
)
from stereo_reconstruction_tpu_torch.ops.smoothing import (
    smoothed_argmin_from_inputs,
    volume_reductions,
)
from stereo_reconstruction_tpu_torch.pipeline import estimate_pose, run_pair
from stereo_reconstruction_tpu_torch.pipeline_batch import batch_uniforms, run_batch, run_batches
from stereo_reconstruction_tpu_torch.pipeline_uncalibrated import run_uncalibrated
from stereo_reconstruction_tpu_torch.config import PerceptualConfig
from stereo_reconstruction_tpu_torch.perceptual import scan as pscan
from stereo_reconstruction_tpu_torch.perceptual.cost import windowed_lpips_search
from stereo_reconstruction_tpu_torch.perceptual.vgg import save_params_npz

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import (  # noqa: E402
    _random_stereo,
    flat_pair,
    narrow_vgg_params,
    nonplanar_disparity,
    nonplanar_scene,
    perceptual_pair,
    perceptual_volume,
    pose_angles,
    request_matches,
)
from test_torch_ransac_host import (  # noqa: E402
    K as RANSAC_K,
    compare,
    scene_case,
    truth_angles,
)
from ransac_twin import card_kernel  # noqa: E402
from torch_helpers import (  # noqa: E402
    STRIP_WIDTHS,
    WARP_IMAGE_CASES,
    chain_planes,
    halo_tile,
    scan_volume,
    seed_rows,
    warp_images,
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
    before = LAUNCHES["K1"]
    ccv.matcher_inputs(torch.from_numpy(left).to(cuda),
                       torch.from_numpy(right).to(cuda), 5, 0, 8)
    assert LAUNCHES["K1"] == before + 1
    ccv.matcher_inputs_plain(torch.from_numpy(left).to(cuda),
                             torch.from_numpy(right).to(cuda), 5, 0, 8)
    assert LAUNCHES["K1"] == before + 1


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
    (3, 4096, 1, 0.9, True),        # 64 strips: 8 CTAs of 8 warps
    (3, 8192, 1, 0.9, True),        # the widest row: 8 CTAs of 16 warps
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


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("h", [1, 2, 282, 1128])
@pytest.mark.parametrize("w", STRIP_WIDTHS)
def test_k1b_bit_equal_to_plain_across_strip_boundaries(cuda, w, h, seeded):
    """Chain planes: a wrong case handed from strip to strip changes the
    pixels to its right; plain and seeded rows."""
    rng = np.random.default_rng(w * 31 + h + seeded)
    ties = (w + h) % 2 == 1
    *planes, black = (torch.from_numpy(a).to(cuda) for a in chain_planes(rng, h, w, 12, ties))
    kw = dict(smooth_factor=1.0 if ties else 0.9, d_first=w % 3, n_planes=12)
    if seeded:
        first, seed = (torch.from_numpy(a).to(cuda) for a in seed_rows(rng, h, w, 12))
        kw.update(first_flags=first, init_prev=seed)
    got = crs.row_scan(*planes, black, **kw)
    assert torch.equal(got, smoothed_argmin_from_inputs(*planes, black, **kw))


def test_block_search_past_4096_columns_runs_k1_and_k1b(cuda, rng):
    left, right = (torch.from_numpy(a).to(cuda) for a in _integer_pair(rng, 6, 6000))
    cfg = MatcherConfig(block_size=5, max_disparity=16)
    k1, k1b = LAUNCHES["K1"], LAUNCHES["K1b"]
    got = block_search_right(left, right, cfg)
    assert (LAUNCHES["K1"] - k1, LAUNCHES["K1b"] - k1b) == (1, 1)
    want = block_search_right(left, right, MatcherConfig(block_size=5, max_disparity=16,
                                                         backend="xla"))
    assert torch.equal(got, want)


def test_k1b_refused_launch_raises_and_counts_nothing(cuda, monkeypatch):
    """A launch the runtime refuses (here a library stub returning
    cudaErrorInvalidConfiguration) raises, naming K1b and the error."""
    from stereo_reconstruction_tpu_torch.kernels import build

    class Refusing:
        def stpu_row_scan_max_width(self):
            return 8192

        def stpu_row_scan(self, *args):
            return 9

        def stpu_error_name(self, err):
            return b"invalid configuration argument"

    cost, black = scan_volume(np.random.default_rng(0), 4, 40, 8)
    planes = volume_reductions(torch.from_numpy(cost).to(cuda), 0)
    monkeypatch.setattr(build, "load_library", lambda: Refusing())
    before = LAUNCHES["K1b"]
    with pytest.raises(RuntimeError, match=r"K1b launch failed: cudaError 9 \(invalid conf"):
        crs.row_scan(*planes, torch.from_numpy(black).to(cuda), n_planes=8)
    assert LAUNCHES["K1b"] == before


def test_k1b_wrapper_checks_and_counts(cuda):
    cost, black = scan_volume(np.random.default_rng(0), 4, 40, 8)
    planes = volume_reductions(torch.from_numpy(cost).to(cuda), 0)
    black = torch.from_numpy(black).to(cuda)
    before = LAUNCHES["K1b"]
    crs.row_scan(*planes, black, n_planes=8)
    assert LAUNCHES["K1b"] == before + 1
    smoothed_argmin_from_inputs(*planes, black, n_planes=8)
    assert LAUNCHES["K1b"] == before + 1
    with pytest.raises(ValueError, match="int32"):
        crs.row_scan(planes[0], planes[1].long(), *planes[2:], black, n_planes=8)
    assert crs.max_width() == 8192
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
    before = (LAUNCHES["K1"], LAUNCHES["K2"], LAUNCHES["K3"])
    ccv.cost_volume(L, R, 5, 0, 8)
    assert (LAUNCHES["K1"], LAUNCHES["K2"], LAUNCHES["K3"]) == (
        before[0], before[1] + 1, before[2])
    cfg = MatcherConfig(block_size=5, max_disparity=8)
    cbs.block_search_fused(L, R, cfg)
    assert (LAUNCHES["K1"], LAUNCHES["K2"], LAUNCHES["K3"]) == (
        before[0], before[1] + 1, before[2] + 1)
    ccv.cost_volume_right_ssd(L, R, 5, 0, 8)
    cbs.block_search_fused_plain(L, R, cfg)
    assert (LAUNCHES["K1"], LAUNCHES["K2"], LAUNCHES["K3"]) == (
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


def test_pose_graphs_equal_the_eager_stage(cuda):
    """The pose stage after SIFT replayed from CUDA graphs
    (``pose/graphs.py``) equals the eager stage bit for bit, on the call
    that captures and on a call with other draws, which replays with no
    host synchronisation; the BA round graph equals ``ba_round``."""
    from stereo_reconstruction_tpu_torch.ops.features import Keypoints, \
        detect_and_describe_batch
    from stereo_reconstruction_tpu_torch.pipeline import pose_from_keypoints
    from stereo_reconstruction_tpu_torch.pose.graphs import pose_graphs
    from stereo_reconstruction_tpu_torch.pose.pipeline import ba_round

    pair, _, _ = _posed_pair()
    cfg = PipelineConfig()
    images = torch.stack([torch.from_numpy(pair.image_left),
                          torch.from_numpy(pair.image_right)]).to(cuda)
    K = torch.from_numpy(pair.intrinsics_left).to(cuda)
    kp = detect_and_describe_batch(images, cfg.frontend)
    for draw in (0, 1):
        u = torch.rand((cfg.ransac.num_hypotheses, cfg.frontend.max_keypoints),
                       generator=torch.Generator().manual_seed(draw)).to(cuda)
        want = pose_from_keypoints(Keypoints(*(x[0] for x in kp)),
                                   Keypoints(*(x[1] for x in kp)), K, K, u, cfg)
        graphs = pose_graphs(kp, K, K, u, cfg)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = graphs(kp, K, K, u)
            args = (got.keypoints_left, got.keypoints_right, K, K, got.pose, got.points,
                    got.weights)
            round_got = graphs.step(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for field in want._fields:
            assert torch.equal(getattr(got, field), getattr(want, field)), (draw, field)
        for a, b in zip(round_got, ba_round(*args, cfg)):
            assert torch.equal(a, b), draw
    assert pose_graphs(kp, K, K, u, cfg) is graphs


def _launches():
    return (LAUNCHES["K1"], LAUNCHES["K1b"], LAUNCHES["K2"], LAUNCHES["K3"])


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


BATCH_CONFIG = PipelineConfig(matcher=MatcherConfig(block_size=7, max_disparity=80))


def _batch_pairs():
    """Two posed 240x320 non-planar scenes (seeds 0, 1) and the flat-row pair,
    whose pose fails, padded to their shape."""
    pairs = []
    for seed in (0, 1):
        left, right, K, _, _, F, src = nonplanar_scene(np.random.default_rng(seed), 240, 320)
        gt, mask = nonplanar_disparity(src, F)
        K = K.astype(np.float32)
        pairs.append(StereoPair(left, right, K, K, disp_right_gt=gt, mask_right_nocc=mask,
                                name=f"s{seed}"))
    fl, fr = flat_pair()
    Kf = np.array([[96.0, 0, 48], [0, 96, 32], [0, 0, 1]], np.float32)
    return pairs + [pad_to(StereoPair(fl, fr, Kf, Kf, name="flat"), 240, 320)]


def test_run_batch_kernel_vs_plain_backend(cuda):
    pairs = _batch_pairs()
    u = batch_uniforms(BATCH_CONFIG, 3)
    before = _launches()
    res = run_batch(pairs, BATCH_CONFIG, uniforms=u, device=cuda)
    # one K1 and one K1b per pair, nothing else
    assert _launches() == (before[0] + 3, before[1] + 3, before[2], before[3])
    assert res.pose_ok.tolist() == [True, True, False]
    plain_cfg = BATCH_CONFIG.replace(matcher=MatcherConfig(block_size=7, max_disparity=80,
                                                           backend="xla"))
    plain = run_batch(pairs, plain_cfg, uniforms=u, device=cuda)
    assert _launches() == (before[0] + 3, before[1] + 3, before[2], before[3])
    assert plain.pose_ok.tolist() == res.pose_ok.tolist()
    for i in range(3):
        # the rectified canvas is not integer-valued: near-tie pixels may flip
        assert np.mean(res.disparity[i] == plain.disparity[i]) >= 0.995, i
    np.testing.assert_array_equal(res.disparity, np.rint(res.disparity))


def test_run_batch_masks_the_failed_pair_on_card(cuda):
    pairs = _batch_pairs()
    u = batch_uniforms(BATCH_CONFIG, 3)
    masked = run_batch(pairs, BATCH_CONFIG, uniforms=u, device=cuda)
    alone = run_batch(pairs[:2], BATCH_CONFIG, uniforms=u[:2], device=cuda)
    assert masked.pose_ok.tolist() == [True, True, False]
    assert alone.pose_ok.tolist() == [True, True]
    for i in range(2):
        assert np.mean(masked.disparity[i] == alone.disparity[i]) >= 0.995, i
    # the failed pair is matched raw (identity homographies): the shift of 5
    assert np.mean(masked.disparity[2][:64, :80] == 5) > 0.9


def test_run_batch_pose_does_not_depend_on_batch_mates(cuda):
    """A pair's keypoints, and so its RANSAC winner, are the same in a batch
    of 1 and of 3 (the detector's blur adds in tap order on the card)."""
    pairs = _batch_pairs()
    u = batch_uniforms(BATCH_CONFIG, 3)
    three = run_batch(pairs, BATCH_CONFIG, uniforms=u, device=cuda)
    for i in range(2):
        one = run_batch(pairs[i:i + 1], BATCH_CONFIG, uniforms=u[i:i + 1], device=cuda)
        assert int(one.pose.num_inliers[0]) == int(three.pose.num_inliers[i])
        np.testing.assert_allclose(one.pose.pose[0, :3, :3].cpu().numpy(),
                                   three.pose.pose[i, :3, :3].cpu().numpy(), atol=1e-4)
        # BA's batched solves still round apart with B, and at 240x320 a
        # small change of F flips ~1% of pair 1's disparities (0.98977 on
        # the H100); at 750x900 chip_smoke holds 99.5%
        assert np.mean(one.disparity[0] == three.disparity[i]) >= 0.98, i


def test_run_batches_on_card_equals_run_batch(cuda):
    pairs = _batch_pairs()
    groups = [pairs[:1], pairs[1:]]
    piped = run_batches(groups, BATCH_CONFIG, fetch_depth=False, device=cuda)
    for i, group in enumerate(groups):
        seq = run_batch(group, BATCH_CONFIG, uniforms=batch_uniforms(BATCH_CONFIG, len(group), i),
                        device=cuda)
        np.testing.assert_array_equal(piped[i].disparity, seq.disparity)
        assert piped[i].pose_ok.tolist() == seq.pose_ok.tolist()
        assert piped[i].depth is None


def test_run_batch_on_a_mesh_equals_its_shards_run_alone(cuda):
    """A data=2 mesh over the card twice: one K1 and one K1b per pair, and
    each shard bit-equal to its two pairs run alone with their draws."""
    from stereo_reconstruction_tpu_torch.parallel import make_mesh

    s0, s1, flat = _batch_pairs()
    pairs = [s0, flat, s1, flat]
    u = batch_uniforms(BATCH_CONFIG, 4)
    before = _launches()
    res = run_batch(pairs, BATCH_CONFIG, uniforms=u,
                    mesh=make_mesh(data=2, tile=1, devices=[cuda, cuda]))
    assert _launches() == (before[0] + 4, before[1] + 4, before[2], before[3])
    assert res.pose_ok.tolist() == [True, False, True, False]
    for i in range(2):
        rows = slice(2 * i, 2 * i + 2)
        alone = run_batch(pairs[rows], BATCH_CONFIG, uniforms=u[rows], device=cuda)
        np.testing.assert_array_equal(res.disparity[rows], alone.disparity)
        np.testing.assert_array_equal(res.depth[rows], alone.depth)
        assert res.metrics[rows] == alone.metrics
        for name, g, w in zip(alone.pose._fields, res.pose, alone.pose):
            np.testing.assert_array_equal(g[rows].cpu().numpy(), w.cpu().numpy(), name)


VARIANTS = {
    "sad": dict(cost="sad"),
    "ncc": dict(cost="ncc"),
    "var_block": dict(var_block=True, var_block_sizes=(5, 7, 9), texture_threshold=60.0),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_variant_launches_k1b_on_the_plain_volume(cuda, rng, variant):
    left, right = _integer_pair(rng, 60, 150, 7)
    cfg = MatcherConfig(block_size=7, min_disparity=1, max_disparity=30, **VARIANTS[variant])
    L, R = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    before = _launches()
    got = block_search_right(L, R, cfg)
    # one K1b launch, no K1, K2 or K3
    assert _launches() == (before[0], before[1] + 1, before[2], before[3])
    plain = block_search_right(L, R, MatcherConfig(backend="xla", block_size=7, min_disparity=1,
                                                   max_disparity=30, **VARIANTS[variant]))
    assert _launches() == (before[0], before[1] + 1, before[2], before[3])
    assert torch.equal(got, plain)              # K1b equals the plain scan
    cpu = block_search_right(torch.from_numpy(left), torch.from_numpy(right), cfg)
    assert np.mean(got.cpu().numpy() == cpu.numpy()) >= 0.995


def test_ncc_volume_on_card_matches_cpu(cuda, rng):
    left, right = _integer_pair(rng, 40, 90, 5)
    got = tcv.cost_volume_right_ncc(torch.from_numpy(left).to(cuda),
                                    torch.from_numpy(right).to(cuda), 9, 0, 20).cpu()
    want = tcv.cost_volume_right_ncc(torch.from_numpy(left), torch.from_numpy(right), 9, 0, 20)
    assert torch.equal(got.isinf(), want.isinf())
    fin = want.isfinite()
    np.testing.assert_allclose(got[fin].numpy(), want[fin].numpy(), rtol=1e-5, atol=1e-4)


def test_left_and_linear_search_on_card_match_cpu(cuda, rng):
    left, right = _integer_pair(rng, 48, 120)
    cfg = MatcherConfig(block_size=7, max_disparity=24)
    L, R = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    got = block_search_left(L, R, cfg)
    assert got.device.type == "cuda"
    want = block_search_left(torch.from_numpy(left), torch.from_numpy(right), cfg)
    assert np.mean(got.cpu().numpy() == want.numpy()) >= 0.995
    before = _launches()
    got = linear_search(L, R, search_range=24)
    # the exact recurrence: one K1b launch
    assert _launches() == (before[0], before[1] + 1, before[2], before[3])
    want = linear_search(torch.from_numpy(left), torch.from_numpy(right), search_range=24)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("detector", ["orb", "brisk", "dog"])
def test_run_uncalibrated_on_card(cuda, tmp_path, detector):
    left, right, *_ = nonplanar_scene(np.random.default_rng(0), 240, 320)
    cfg = PipelineConfig(matcher=MatcherConfig(max_disparity=64))
    before = _launches()
    res = run_uncalibrated(left, right, cfg, detector=detector, output_dir=str(tmp_path),
                           device=cuda)
    # linear_search's one K1b launch
    assert _launches() == (before[0], before[1] + 1, before[2], before[3])
    # the JAX package's recorded gate (tests/test_uncalibrated.py)
    assert res.num_inliers >= 30 and res.epipolar_alignment_px <= 2.0
    assert res.F_rectified is not None and np.isfinite(res.disparity).all()
    for name in ("rectified_left.png", "rectified_right.png", "disparity_linear.png"):
        assert os.path.exists(os.path.join(str(tmp_path), name))


@pytest.mark.parametrize("h,d,w,chunk,ties", [
    (6, 12, 50, 20, False), (5, 12, 50, 20, True), (4, 7, 1, 20, False),
    (5, 8, 33, 1, True), (4, 40, 45, 20, False), (3, 30, 70, 7, True),
    (3, 12, 40, 64, False), (3, 100, 450, 20, True), (2, 200, 700, 33, False),
    # NaN, +0.0 and -0.0; H = 1 and H < len; D = 33 and 200; chunk 1; a warp
    # with several positions (chunk 33, 64); W = chunk + 1
    (5, 12, 50, 20, "specials"), (3, 100, 450, 20, "specials"), (1, 12, 50, 20, False),
    (3, 12, 60, 20, True), (4, 33, 50, 20, False), (3, 200, 450, 20, True),
    (3, 12, 20, 1, "specials"), (4, 12, 70, 33, True), (3, 40, 130, 64, "specials"),
    (4, 12, 21, 20, False),
    # 2, 1 and no staged rows a position
    (3, 150, 127, 120, True), (2, 200, 127, 120, False), (2, 300, 157, 150, "specials"),
    (2, 600, 107, 100, False),
])
def test_k4_bit_equal_to_plain_on_planted_volumes(cuda, h, d, w, chunk, ties):
    vol = torch.from_numpy(perceptual_volume(np.random.default_rng(w + chunk), h, d, w,
                                             ties=ties is True,
                                             specials=ties == "specials")).to(cuda)
    table = pscan.weight_table(d, 25.0, 0.85, cuda)
    got = pscan.window_scan(vol, table, chunk)
    want = pscan.window_scan_plain(vol, table, chunk)
    assert got.device.type == "cuda" and torch.equal(got, want)


def test_k4_wrapper_checks_and_counts(cuda):
    vol = torch.from_numpy(perceptual_volume(np.random.default_rng(0), 3, 12, 40)).to(cuda)
    table = pscan.weight_table(12, 25.0, 0.85, cuda)
    before = LAUNCHES["K4"]
    pscan.window_scan(vol, table, 20)
    assert LAUNCHES["K4"] == before + 1
    pscan.window_scan_plain(vol, table, 20)
    assert LAUNCHES["K4"] == before + 1
    with pytest.raises(ValueError, match="one CUDA device"):
        pscan.window_scan(vol, table.cpu(), 20)
    with pytest.raises(ValueError, match="D \\+ 1 = 13"):
        pscan.window_scan(vol, table[:12].contiguous(), 20)
    with pytest.raises(ValueError, match="chunk >= 1"):
        pscan.window_scan(vol, table, 0)
    with pytest.raises(ValueError, match="float32"):
        pscan.window_scan(vol.double(), table, 20)
    with pytest.raises(ValueError, match="contiguous"):
        pscan.window_scan(vol.transpose(1, 2).contiguous().transpose(1, 2), table, 20)
    # D = 2000 with chunk 64 stages no row (the direct instance): a run
    big = torch.from_numpy(perceptual_volume(np.random.default_rng(1), 2, 2000, 64)).to(cuda)
    big_table = pscan.weight_table(2000, 25.0, 0.85, cuda)
    assert torch.equal(pscan.window_scan(big, big_table, 64),
                       pscan.window_scan_plain(big, big_table, 64))
    assert LAUNCHES["K4"] == before + 2
    # the table and two rows of chunk indices must fit
    wide = torch.zeros((1, 1, 30000), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        pscan.window_scan(wide, pscan.weight_table(1, 25.0, 0.85, cuda), 30000)
    assert pscan.max_smem() == 232448
    assert LAUNCHES["K4"] == before + 2


def test_windowed_search_on_card_matches_cpu(cuda, tmp_path):
    left, right = perceptual_pair(np.random.default_rng(1), 20, 60)
    params = narrow_vgg_params()
    cfg = PerceptualConfig(max_disparity=16, row_block=8)
    before = LAUNCHES["K4"]
    got = windowed_lpips_search(params, torch.from_numpy(left).to(cuda),
                                torch.from_numpy(right).to(cuda), cfg)
    assert LAUNCHES["K4"] == before + 1 and got.device.type == "cuda"
    want = windowed_lpips_search(params, torch.from_numpy(left), torch.from_numpy(right), cfg)
    got = got.cpu().numpy()
    want = want.numpy()
    assert np.mean(np.abs(got - want) <= 2) == 1.0 and np.mean(got == want) >= 0.98
    # the same through compute_disparity with the weights from a file
    from stereo_reconstruction_tpu_torch.pipeline import compute_disparity

    path = str(tmp_path / "narrow.npz")
    save_params_npz(path, params)
    config = PipelineConfig()
    config = config.replace(
        matcher=MatcherConfig(cost="perceptual", max_disparity=16),
        perceptual=PerceptualConfig(weights_path=path))
    disp = compute_disparity(torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda),
                             config)
    assert LAUNCHES["K4"] == before + 2 and disp.device.type == "cuda"
    assert np.mean(disp.cpu().numpy() == got) >= 0.995


# global-row mode (the sharded matcher's tiles): (image rows, tile row 0,
# tile rows, width, block, min_d, max_d); rows outside the image are zero
GLOBAL_CASES = [
    (60, -6, 30, 70, 7, 0, 20),        # the top tile, padding above the image
    (60, 17, 30, 70, 9, 2, 24),        # an inner tile, min_d > 0
    (60, 40, 30, 70, 5, 0, 16),        # the bottom tile, padding below
    (300, 100, 130, 200, 17, 0, 40),   # interior CTAs of an inner tile
    (300, -40, 130, 200, 17, 1, 30),   # whole rows outside the image (area 0)
]


@pytest.mark.parametrize("h,row0,n,w,bs,min_d,max_d", GLOBAL_CASES)
def test_k1_k2_global_rows_bit_equal_to_plain(cuda, rng, h, row0, n, w, bs, min_d, max_d):
    left, right = (torch.from_numpy(a).to(cuda).float() for a in _integer_pair(rng, h, w))
    lt, rt = halo_tile(left, row0, n), halo_tile(right, row0, n)
    g = dict(row_offset=row0, total_height=h)
    args = (bs, min_d, max_d)
    got = ccv.matcher_inputs(lt, rt, *args, **g)
    want = ccv.matcher_inputs_plain(lt, rt, *args, **g)
    for name, a, b in zip(("m0", "a0", "c_zero", "diag_up", "diag_lf"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    vol = ccv.cost_volume(lt, rt, *args, **g)
    assert torch.equal(vol, ccv.cost_volume_right_ssd(lt, rt, *args, **g))
    # the rows whose window support the tile holds equal the whole image's
    hw = bs - 1
    lo, hi = max(row0 + hw, 0), min(row0 + n - hw, h)
    whole = ccv.matcher_inputs(left, right, *args)
    for a, b in zip(got, whole):
        assert torch.equal(a[lo - row0:hi - row0], b[lo:hi])
    assert torch.equal(vol[:, lo - row0:hi - row0], ccv.cost_volume(left, right, *args)[:, lo:hi])


@pytest.mark.parametrize("h,w,d_first", [(9, 33, 0), (7, 1100, 2), (6, 2500, 0), (5, 4096, 1),
                                         (4, 8192, 2)])
def test_k1b_seeded_bit_equal_to_plain(cuda, h, w, d_first):
    srng = np.random.default_rng(w)
    cost, black = scan_volume(srng, h, w, 12)
    planes = volume_reductions(torch.from_numpy(cost).to(cuda), d_first)
    black = torch.from_numpy(black).to(cuda)
    first = torch.from_numpy(srng.random(h) < 0.3).to(cuda)
    xs = np.arange(w, dtype=np.float32)
    seed = np.choose(srng.integers(0, 3, w), [np.zeros(w, np.float32), -xs,
                                              srng.integers(0, 12, w)]).astype(np.float32)
    kw = dict(smooth_factor=0.9, d_first=d_first, n_planes=12, first_flags=first,
              init_prev=torch.from_numpy(seed).to(cuda))
    assert torch.equal(crs.row_scan(*planes, black, **kw),
                       smoothed_argmin_from_inputs(*planes, black, **kw))
    with pytest.raises(ValueError, match="first_flags"):
        crs.row_scan(*planes, black, n_planes=12, first_flags=first.float())


def test_k1b_seeded_tiles_chain_to_one_launch(cuda, rng):
    left, right = (torch.from_numpy(a).to(cuda) for a in _integer_pair(rng, 120, 150))
    planes = ccv.matcher_inputs(left, right, 9, 0, 30)
    black = black_pixel_mask(right.float())
    kw = dict(n_planes=30)
    whole = crs.row_scan(*planes, black, **kw)
    seed, parts = torch.zeros(150, device=cuda), []
    for t in range(4):
        sl = slice(30 * t, 30 * (t + 1))
        first = torch.zeros(30, dtype=torch.bool, device=cuda)
        first[0] = t == 0
        parts.append(crs.row_scan(*(p[sl] for p in planes), black[sl], **kw,
                                  first_flags=first, init_prev=seed))
        seed = parts[-1][-1]
    assert torch.equal(torch.cat(parts), whole)


def test_sharded_matcher_on_card(cuda, rng):
    from stereo_reconstruction_tpu_torch.parallel import make_mesh, sharded_block_search_right

    pairs = [_integer_pair(rng, 96, 128) for _ in range(2)]
    left = torch.from_numpy(np.stack([p[0] for p in pairs])).to(cuda)
    right = torch.from_numpy(np.stack([p[1] for p in pairs])).to(cuda)
    mesh = make_mesh(data=2, tile=4, devices=[cuda] * 8)
    cfg = MatcherConfig(block_size=9, max_disparity=24)
    k1, k1b = LAUNCHES["K1"], LAUNCHES["K1b"]
    got = sharded_block_search_right(left, right, mesh, cfg, exact=True)
    assert (LAUNCHES["K1"] - k1, LAUNCHES["K1b"] - k1b) == (8, 32)
    single = torch.stack([block_search_right(left[i], right[i], cfg) for i in range(2)])
    assert torch.equal(got, single)
    plain = sharded_block_search_right(left.cpu(), right.cpu(),
                                       make_mesh(data=2, tile=4, devices=["cpu"] * 8),
                                       cfg, exact=True)
    assert torch.equal(got.cpu(), plain)


def _warp_maps(rng, n, kind):
    """n float32 inverse maps (destination -> source) of one kind."""
    out = []
    for _ in range(n):
        if kind == "near":           # a mild perspective map, most pixels inside
            m = [[1.02, 0.03, rng.uniform(-5, 5)], [-0.02, 0.99, rng.uniform(-5, 5)],
                 [rng.uniform(-2e-4, 2e-4), rng.uniform(-2e-4, 2e-4), 1.0]]
        elif kind == "outside":      # most pixels outside the source
            m = [[3.0, 0.2, -50], [0.1, 2.5, 40], [rng.uniform(-1e-3, 1e-3), 2e-3, 1.0]]
        elif kind == "zero_denom":   # the denominator is exactly 0 on column 16 or row 12
            m = ([[1.0, 0.1, 2.0], [0.05, 1.0, 1.0], [0.0625, 0.0, -1.0]] if len(out) % 2
                 else [[1.0, 0.1, 2.0], [0.05, 1.0, 1.0], [0.0, 0.125, -1.5]])
        else:
            m = np.eye(3) + rng.normal(0, [[0.1, 0.1, 10], [0.1, 0.1, 10], [1e-3, 1e-3, 0.05]])
        out.append(np.asarray(m, np.float32))
    return torch.from_numpy(np.stack(out))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("channels,dtype", [(None, np.uint8), (1, np.uint8), (3, np.uint8),
                                            (None, np.float32), (3, np.float32)])
@pytest.mark.parametrize("n,kind,out_shape", [(1, "near", (48, 64)), (2, "outside", (45, 61)),
                                              (3, "zero_denom", (30, 50)),
                                              (37, "random", (40, 52))])
def test_warp_kernel_bit_equal_to_plain(cuda, rng, method, channels, dtype, n, kind, out_shape):
    imgs = []
    for _ in range(n):
        h, w = int(rng.integers(20, 60)), int(rng.integers(20, 70))
        shape = (h, w) if channels is None else (h, w, channels)
        a = (rng.integers(0, 256, shape) if dtype == np.uint8
             else rng.uniform(-50, 50, shape)).astype(dtype)      # negatives: -0.0 outside
        imgs.append(torch.from_numpy(a).to(cuda))
    hinv = _warp_maps(rng, n, kind)
    before = LAUNCHES["warp"]
    got = cuda_warp.warp(imgs, hinv, out_shape, method)
    assert LAUNCHES["warp"] == before + (2 if n > 32 else 1)
    want = torch.stack([warp_inverse_map(img, m.to(cuda), out_shape, method)
                        for img, m in zip(imgs, hinv)])
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.device == want.device
    assert torch.equal(_bits(got), _bits(want))
    if dtype == np.float32 and kind == "outside":
        assert bool(((got == 0) & torch.signbit(got)).any())


def test_warp_kernel_at_the_canvas_bit_equal_to_plain(cuda):
    left, right, _, _, _, F, _ = nonplanar_scene(np.random.default_rng(0), 750, 900)
    rect = rectify_pair(torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda), F)
    homs = rect.homographies
    for side, img, H in (("left", left, homs.H_left), ("right", right, homs.H_right)):
        hinv = torch.linalg.inv(torch.as_tensor(H, dtype=torch.float32)).to(cuda)
        want = warp_inverse_map(torch.from_numpy(img).to(cuda), hinv, rect.canvas)
        assert torch.equal(_bits(getattr(rect, side)), _bits(want)), side
    disp = torch.from_numpy(np.random.default_rng(1).uniform(-5, 200, rect.canvas)
                            .astype(np.float32)).to(cuda)
    back = disparity_to_original_frame(disp, homs.H_right, (750, 900))
    m = torch.linalg.inv(torch.linalg.inv(torch.as_tensor(homs.H_right, dtype=torch.float32)))
    want = warp_inverse_map(disp, m.to(cuda), (750, 900), method="nearest")
    assert torch.equal(_bits(back), _bits(want))


@pytest.mark.parametrize("case", WARP_IMAGE_CASES)
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_warp_takes_what_the_twin_takes(cuda, rng, case, method):
    """Another dtype, a view, 2 or 4 channels, uint8 beside float32: the
    card's route gives the twin's output on the card and the CPU route's,
    bit for bit, in one launch (a plane a channel for 2 and 4)."""
    imgs = warp_images(rng, case)
    H = np.stack([np.eye(3) + rng.normal(0, [[0.05, 0.05, 4], [0.05, 0.05, 4],
                                             [5e-4, 5e-4, 0.02]]) for _ in imgs])
    before = LAUNCHES["warp"]
    got = warp_perspective([img.to(cuda) for img in imgs], H, (36, 44), method)
    assert LAUNCHES["warp"] == before + 1
    hinv = torch.linalg.inv(torch.from_numpy(H).float())
    on_card = torch.stack([warp_inverse_map(img.to(cuda), m.to(cuda), (36, 44), method)
                           for img, m in zip(imgs, hinv)])
    torch.cuda.synchronize()
    assert got.shape == on_card.shape and got.is_contiguous()
    assert torch.equal(_bits(got), _bits(on_card))
    assert torch.equal(_bits(got.cpu()), _bits(warp_perspective(imgs, H, (36, 44), method)))


def test_warp_wrapper_checks(cuda):
    img = torch.zeros((10, 12, 3), dtype=torch.uint8, device=cuda)
    maps = torch.eye(3)[None].repeat(2, 1, 1)
    before = LAUNCHES["warp"]
    with pytest.raises(ValueError, match="share their channels"):
        warp_inverse_maps([img, img[..., :2]], maps, (8, 8))
    with pytest.raises(ValueError, match="float32 on the CPU"):
        warp_inverse_maps([img], maps[:1].to(cuda), (8, 8))
    with pytest.raises(ValueError, match="one CUDA device"):
        warp_inverse_maps([img, img.cpu()], maps, (8, 8))
    with pytest.raises(ValueError, match="unknown warp method"):
        warp_inverse_maps([img], maps[:1], (8, 8), "cubic")
    with pytest.raises(ValueError, match="non-empty"):
        warp_inverse_maps([img[:0]], maps[:1], (8, 8))
    with pytest.raises(torch.linalg.LinAlgError):
        warp_perspective([img], np.zeros((1, 3, 3)), (8, 8))
    assert LAUNCHES["warp"] == before


def test_rectify_and_backwarp_make_no_host_sync(cuda):
    left, right, _, _, _, F, _ = nonplanar_scene(np.random.default_rng(4), 240, 320)
    left, right = torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda)
    disp = rectify_pair(left, right, F).left[..., 0]   # a view; builds the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rect = rectify_pair(left, right, F)
        disparity_to_original_frame(disp, rect.homographies.H_right, (240, 320))
        disparity_to_original_frame(disp, rect.homographies.H_right, (240, 320),
                                    compat_left_homography=rect.homographies.H_left)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_rectify_and_backwarp_on_card_equal_cpu(cuda):
    left, right, _, _, _, F, _ = nonplanar_scene(np.random.default_rng(2), 375, 450)
    got = rectify_pair(torch.from_numpy(left).to(cuda), torch.from_numpy(right).to(cuda), F)
    want = rectify_pair(torch.from_numpy(left), torch.from_numpy(right), F)
    assert got.canvas == want.canvas
    for side in ("left", "right"):
        assert torch.equal(_bits(getattr(got, side).cpu()), _bits(getattr(want, side))), side
    disp = np.random.default_rng(3).uniform(-5, 100, got.canvas).astype(np.float32)
    for compat in (None, want.homographies.H_left):
        args = (want.homographies.H_right, (375, 450))
        g = disparity_to_original_frame(torch.from_numpy(disp).to(cuda), *args,
                                        compat_left_homography=compat)
        w = disparity_to_original_frame(torch.from_numpy(disp), *args,
                                        compat_left_homography=compat)
        assert torch.equal(_bits(g.cpu()), _bits(w))


def test_warp_launches_twice_a_fixed_F_run_pair(cuda, tmp_path):
    from stereo_reconstruction_tpu_torch.pipeline import compute_disparity

    left, right, K, _, _, F, _ = nonplanar_scene(np.random.default_rng(4), 240, 320)
    pair = StereoPair(left, right, K.astype(np.float32), K.astype(np.float32), name="F")
    before = LAUNCHES["warp"]
    run_pair(pair, PipelineConfig(matcher=MatcherConfig(block_size=7, max_disparity=80)),
             fixed_F=F, device=cuda)
    assert LAUNCHES["warp"] == before + 2
    # the perceptual search on a rectified pair never warps
    pl, pr = perceptual_pair(np.random.default_rng(1), 20, 60)
    path = str(tmp_path / "narrow.npz")
    save_params_npz(path, narrow_vgg_params())
    config = PipelineConfig().replace(matcher=MatcherConfig(cost="perceptual", max_disparity=16),
                                      perceptual=PerceptualConfig(weights_path=path))
    compute_disparity(torch.from_numpy(pl).to(cuda), torch.from_numpy(pr).to(cuda), config)
    assert LAUNCHES["warp"] == before + 2
    # run_batch: the 2B rectifying warps in one launch, the back-warps in another
    run_batch(_batch_pairs(), BATCH_CONFIG, uniforms=batch_uniforms(BATCH_CONFIG, 3),
              device=cuda)
    assert LAUNCHES["warp"] == before + 4


@pytest.mark.parametrize("case", ["posed_request_matches", "far_winner_request", "scene",
                                  "duplicates", "no_valid", "past_shared_keys"])
def test_ransac_kernel_equals_twin_on_card(cuda, case):
    from stereo_reconstruction_tpu_torch.config import RansacConfig

    config = RansacConfig()
    if case == "scene":
        ml, mr, nv = scene_case(7, 500, 333)
    elif case == "duplicates":
        ml, mr, nv = scene_case(8, 300, 240, duplicates=3)
    elif case == "no_valid":
        ml, mr, nv = scene_case(17, 120, 100, outliers=0.0, behind=0.5)
        config = RansacConfig(num_hypotheses=64)
    elif case == "past_shared_keys":
        ml, mr, nv = scene_case(9, cuda_ransac.shared_keys() + 100, 300)
        config = RansacConfig(num_hypotheses=64)
    else:
        ml, mr, nv = request_matches(case, 500)
    compare(card_kernel, ml, mr, nv, config, device=cuda)


def test_posed_run_pair_launches_the_ransac_kernel_twice(cuda):
    pair, _, _ = _posed_pair()
    cfg = PipelineConfig(matcher=MatcherConfig(block_size=7, max_disparity=80))
    run_pair(pair, cfg, device=cuda)            # captures the pose stage's graphs
    before = LAUNCHES["ransac"]
    res = run_pair(pair, cfg, device=cuda)
    assert LAUNCHES["ransac"] == before + 2
    assert res.metrics["pose_ok"] == 1.0
    _, _, _, _, _, F, _ = nonplanar_scene(np.random.default_rng(4), 240, 320)
    run_pair(pair, cfg, fixed_F=F, device=cuda)
    assert LAUNCHES["ransac"] == before + 2


def test_run_batch_of_four_posed_pairs_launches_the_ransac_kernel_twice(cuda):
    """At 240x384 the batch needs no padding, so each pair's pose stage sees
    what its ``run_pair`` sees."""
    pairs = []
    for seed in range(4):
        left, right, K, _, _, _, _ = nonplanar_scene(np.random.default_rng(seed), 240, 384)
        pairs.append(StereoPair(left, right, K.astype(np.float32), K.astype(np.float32),
                                name=f"posed{seed}"))
    u = batch_uniforms(BATCH_CONFIG, 4)
    before = LAUNCHES["ransac"]
    res = run_batch(pairs, BATCH_CONFIG, uniforms=u, device=cuda)
    assert LAUNCHES["ransac"] == before + 2
    for i, pair in enumerate(pairs):
        one = run_pair(pair, BATCH_CONFIG, device=cuda, uniforms=u[i])
        # test_pose_stage_on_card_matches_cpu's limit
        np.testing.assert_allclose(res.pose.pose[i, :3, :3].cpu().numpy(),
                                   one.pose.pose[:3, :3].cpu().numpy(), atol=1e-3)


@pytest.mark.parametrize("name", ["posed_request_matches", "far_winner_request"])
def test_ransac_kernel_poses_the_fixtures_on_card(cuda, name):
    """The benchmark's two hard requests (seed 3100000041 request 0, seed
    3000003002 request 205): RANSAC on the card, then BA, within the
    configuration's 0.5 / 2 degrees for each of three draws."""
    from stereo_reconstruction_tpu_torch.pose.pipeline import estimate_pose_from_matches, \
        settle_pose
    from stereo_reconstruction_tpu_torch.pose.ransac import draw_uniforms

    cfg = PipelineConfig()
    ml, mr, nv = request_matches(name, 500)
    Kt = torch.from_numpy(RANSAC_K).to(cuda)
    for seed in range(3):
        u = draw_uniforms(cfg.ransac, ml.shape[1], torch.Generator().manual_seed(seed))
        est = settle_pose(estimate_pose_from_matches(ml.to(cuda), mr.to(cuda), Kt, Kt, cfg, nv,
                                                     u.to(cuda)), Kt, Kt, cfg)
        rot, trans = truth_angles(est.pose)
        assert bool(est.valid) and rot <= 0.5 and trans <= 2.0, (seed, rot, trans)


def test_posed_run_pair_past_shared_keys(cuda):
    """More matches than shared memory holds the refits' keys for
    (max_keypoints past ``stpu_ransac_shared_keys``): the kernel keeps them
    in its scratch, and the card poses the pair as the CPU does, to
    ``test_pose_stage_on_card_matches_cpu``'s limits."""
    import dataclasses

    pair, R, T = _posed_pair()
    cfg = PipelineConfig()
    n = cuda_ransac.shared_keys() + 100
    cfg = cfg.replace(frontend=dataclasses.replace(cfg.frontend, max_keypoints=n))
    estimate_pose(pair, cfg, device=cuda)      # captures the pose stage's graphs
    before = LAUNCHES["ransac"]
    got = estimate_pose(pair, cfg, device=cuda)
    assert LAUNCHES["ransac"] == before + 2
    want = estimate_pose(pair, cfg, device="cpu")
    assert bool(got.valid) and bool(want.valid)
    np.testing.assert_allclose(got.pose.cpu().numpy()[:3, :3], want.pose.numpy()[:3, :3],
                               atol=1e-3)
    rot, trans = pose_angles(got.pose.cpu().numpy(), R, T)
    assert rot < 1.0 and trans < 5.0


@pytest.mark.parametrize("field,value", [("sample_size", 33), ("refine_support", 40)])
def test_posed_run_pair_refuses_a_ransac_config_before_sift(cuda, monkeypatch, field, value):
    """A RANSAC configuration the card's kernel does not take raises
    ``ValueError`` before the pose stage's SIFT runs."""
    import dataclasses

    from stereo_reconstruction_tpu_torch import pipeline as pipeline_mod

    def no_sift(*args, **kwargs):
        raise AssertionError("SIFT ran")

    monkeypatch.setattr(pipeline_mod, "detect_and_describe_batch", no_sift)
    pair, _, _ = _posed_pair()
    cfg = PipelineConfig()
    cfg = cfg.replace(ransac=dataclasses.replace(cfg.ransac, **{field: value}))
    with pytest.raises(ValueError, match="RANSAC kernel"):
        run_pair(pair, cfg, device=cuda)


def test_distributed_ba_batch_equals_each_pair_on_card(cuda):
    """On the card each problem of ``distributed_bundle_adjust_batch`` gives
    the bits of ``distributed_bundle_adjust`` on it alone: the pose's
    translation and the points share a scale no residual sees, so a batch
    that rounded apart drifted along it (up to 2.4e-2 in T on the smoke's
    scenes)."""
    from stereo_reconstruction_tpu_torch.ops import geometry as geo
    from stereo_reconstruction_tpu_torch.parallel import (distributed_bundle_adjust,
                                                          distributed_bundle_adjust_batch,
                                                          make_mesh)

    rng = np.random.default_rng(7)
    K = torch.tensor([[500.0, 0, 160], [0, 500.0, 120], [0, 0, 1]], device=cuda)
    n = 64
    depth = torch.from_numpy(rng.uniform(4, 9, n).astype(np.float32)).to(cuda)
    xy = torch.from_numpy(rng.uniform(-0.25, 0.25, (2, n)).astype(np.float32)).to(cuda)
    pts = torch.cat([xy, torch.ones(1, n, device=cuda)]) * depth
    R = geo.angle_axis_to_rotation(torch.tensor([0.03, -0.05, 0.02], device=cuda))
    T = torch.tensor([-0.6, 0.05, 0.2], device=cuda)
    noise = torch.from_numpy(rng.normal(0, 0.5, (2, 2, n)).astype(np.float32)).to(cuda)
    kl, kr = geo.project(K, pts), geo.project(K, geo.transform(R, T, pts))
    kl = torch.cat([kl[:2] + noise[0], kl[2:]])
    kr = torch.cat([kr[:2] + noise[1], kr[2:]])
    problems = [(geo.angle_axis_to_rotation(geo.rotation_to_angle_axis(R) + 0.03 + 0.01 * i),
                 T + 0.05) for i in range(3)]
    mesh = make_mesh(data=2, tile=4, devices=[cuda] * 8)
    B = len(problems)
    poses, _, _, cf, X = distributed_bundle_adjust_batch(
        torch.stack([kl] * B), torch.stack([kr] * B), K, K,
        torch.stack([p[0] for p in problems]), torch.stack([p[1] for p in problems]),
        torch.stack([pts] * B), mesh)
    for i, (Ri, Ti) in enumerate(problems):
        one = distributed_bundle_adjust(kl, kr, K, K, Ri, Ti, pts, mesh)
        assert torch.equal(poses[i], one.pose) and torch.equal(X[i], one.points)
        assert torch.equal(cf[i], one.final_cost)
