"""Dense window-search disparity (reference BlockSearch, BlockSearch.cpp:24-179).

Port of ``stereo_reconstruction_tpu/ops/block_search.py``. A negative
``min_disparity`` raises on every route of ``block_search_right``: the JAX
reference is wrong there (ROADMAP, Queue 3).

``block_search_right`` (BlockSearch::computeDisparityMapRight):

  * SSD, kernel backend: K1 (``ops/cuda_cost_volume.py``) emits the five
    smoothing-scan planes directly, then K1b (``ops/cuda_row_scan.py``)
    runs the exact row scan;
  * SSD, plain backend: the full cost volume (``ops/cost_volume.py``), its
    reductions, then the same row scan;
  * SAD, NCC and the variable block (``var_block``): the plain volume on
    every backend, as in the JAX package, its reductions, then the row scan:
    K1b on the kernel backend, its plain twin on the plain one.

``block_search_left`` (BlockSearch::computeDisparityMapLeft) runs the
Left volume through the fixpoint smoother (``smoothing.smoothed_argmin``)
on every backend.

The variable-window mode picks per pixel among a bounded set of window
sizes by the reference's texture test (grow while ||max(0, win - mean)|| <
threshold, BlockSearch.cpp:125-142); the reference's unbounded growth is
capped at the largest configured size, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from stereo_reconstruction_tpu_torch.config import MatcherConfig
from stereo_reconstruction_tpu_torch.ops import cost_volume as cv
from stereo_reconstruction_tpu_torch.ops import cuda_cost_volume as ccv
from stereo_reconstruction_tpu_torch.ops import cuda_row_scan as crs
from stereo_reconstruction_tpu_torch.ops import smoothing


def use_kernel(config: MatcherConfig, device: torch.device) -> bool:
    """Resolve ``config.backend`` for tensors on ``device``."""
    if config.backend == "pallas":
        if device.type != "cuda":
            raise ValueError("backend='pallas' (the CUDA kernel) needs CUDA tensors")
        return True
    if config.backend == "auto":
        return device.type == "cuda"
    if config.backend == "xla":
        return False
    raise ValueError(f"unknown matcher backend {config.backend!r}")


def block_search_right(
    left: torch.Tensor,       # (H, W_l, 3) rectified left image (float32/uint8)
    right: torch.Tensor,      # (H, W, 3) rectified right image
    config: MatcherConfig = MatcherConfig(),
) -> torch.Tensor:
    """Disparity of the right image, (H, W) float32: black pixels 0,
    pixels without a candidate ``-x``."""
    if config.cost not in ("ssd", "sad", "ncc"):
        raise NotImplementedError(
            f"cost={config.cost!r}: block_search_right computes ssd, sad and ncc; "
            "the perceptual cost runs through pipeline.compute_disparity")
    kernel = use_kernel(config, right.device)
    if config.min_disparity < 0:
        # the JAX package's answers there cannot be checked: its Pallas cost
        # volume keeps the wrong columns for a negative shift, its XLA one
        # clamps negative starts to d = 0, and its oracle slices negative
        # column starts (ROADMAP, Queue 3)
        raise NotImplementedError(
            "min_disparity < 0: the JAX reference is wrong there, so the port "
            "refuses it on every backend")
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    black = cv.black_pixel_mask(right)
    volume_args = (config.block_size, config.min_disparity, config.max_disparity)
    if config.var_block:
        planes = smoothing.volume_reductions(_varblock_cost(left, right, config),
                                             config.min_disparity)
    elif config.cost == "ncc":
        planes = smoothing.volume_reductions(
            cv.cost_volume_right_ncc(left, right, *volume_args), config.min_disparity)
    elif config.cost == "sad":
        planes = smoothing.volume_reductions(
            cv.cost_volume_right_sad(left, right, *volume_args), config.min_disparity)
    elif kernel:
        planes = ccv.matcher_inputs(left, right, *volume_args)
    else:
        planes = ccv.matcher_inputs_plain(left, right, *volume_args)
    scan = crs.row_scan if kernel else smoothing.smoothed_argmin_from_inputs
    return scan(*planes, black, smooth_factor=config.smooth_factor,
                d_first=config.min_disparity,
                n_planes=config.max_disparity - config.min_disparity)


def block_search_left(
    left: torch.Tensor,       # (H, W, 3)
    right: torch.Tensor,      # (H, W_r, 3)
    config: MatcherConfig = MatcherConfig(),
) -> torch.Tensor:
    """Disparity of the left image, (H, W) float32 (BlockSearch.cpp:24-86):
    disparities 1..max_disparity, the +d smoothing discount, black left
    pixels and the border (outside [hbs, H-hbs) x [hbs, W-hbs)) 0."""
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    h = min(left.shape[0], right.shape[0])
    cost = cv.cost_volume_left_ssd(left, right, config.block_size, config.max_disparity)
    dvals = torch.arange(1, config.max_disparity + 1, device=left.device)
    disp = smoothing.smoothed_argmin(
        cost, dvals, cv.black_pixel_mask(left), smooth_factor=config.smooth_factor,
        mode="intended",   # the Left variant's discount has the correct sign
        iters=None,        # in-row sweeps to the fixpoint: exact
        variant="left")
    # the reference leaves border pixels at 0; their cost planes are all
    # +inf, so they hold the sentinel x here
    hbs = (config.block_size - 1) // 2
    ys = torch.arange(disp.shape[0], device=disp.device)[:, None]
    xs = torch.arange(disp.shape[1], device=disp.device)[None, :]
    interior = (ys >= hbs) & (ys < h - hbs) & (xs >= hbs) & (xs < left.shape[1] - hbs)
    return torch.where(interior, disp, 0.0)


def _varblock_cost(left, right, config: MatcherConfig) -> torch.Tensor:
    """SSD cost volume with each pixel's window size picked by texture."""
    sizes = tuple(sorted(config.var_block_sizes))
    sel = _texture_select(right, sizes, config.texture_threshold)  # (H, W) int
    out = None
    for k, bs in enumerate(sizes):
        c = cv.cost_volume_right_ssd(left, right, bs, config.min_disparity,
                                     config.max_disparity)
        out = c if out is None else torch.where((sel == k)[None], c, out)
    return out


def _texture_select(right, sizes: Tuple[int, ...], threshold: float) -> torch.Tensor:
    """Per-pixel index of the first window size whose texture measure
    passes the threshold (the largest size where none does)."""
    h, w = right.shape[:2]
    sel = torch.full((h, w), len(sizes) - 1, dtype=torch.int32, device=right.device)
    for k in reversed(range(len(sizes) - 1)):
        sel = torch.where(window_texture(right, sizes[k]) >= threshold, k, sel)
    return sel


def window_texture(image: torch.Tensor, block_size: int) -> torch.Tensor:
    """The reference texture measure over the clipped window
    (BlockSearch.cpp:125-128): ||max(0, v - round(mean))||_2 per pixel,
    with the per-channel window mean of the centre pixel (cv::subtract's
    uint8 saturation is the clamp at 0). A windowed sum of shifted images,
    one pass per window offset; every term is an integer, so the sum is
    exact."""
    image = image.to(torch.float32)
    device = image.device
    hbs = (block_size - 1) // 2
    h, w = image.shape[:2]
    _, _, _, _, area = cv.right_window_geometry(h, w, block_size, device)
    sums = torch.stack([cv.clipped_window_sum(image[..., c], hbs)
                        for c in range(image.shape[-1])], dim=-1)
    mean = sums / area.clamp(min=1.0)[..., None]
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    up, down = ys.clamp(max=hbs), (h - 1 - ys).clamp(max=hbs)
    lft, rgt = xs.clamp(max=hbs), (w - 1 - xs).clamp(max=hbs)
    total = torch.zeros((h, w), dtype=torch.float32, device=device)
    for dy in range(-hbs, hbs):
        shifted_y = torch.roll(image, -dy, dims=0)
        in_y = (dy >= -up) & (dy < down)
        for dx in range(-hbs, hbs):
            v = torch.roll(shifted_y, -dx, dims=1)
            in_x = (dx >= -lft) & (dx < rgt)
            diff = torch.round(v - mean).clamp(0.0, 255.0)
            sq = diff * diff
            contrib = sq[..., 0]
            for c in range(1, sq.shape[-1]):
                contrib = contrib + sq[..., c]
            total = total + torch.where(in_y & in_x, contrib, 0.0)
    return cv.sqrt_rn(total)
