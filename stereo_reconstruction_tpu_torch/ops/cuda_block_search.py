"""K3: the fused block-search kernel (``csrc/block_search.cuh``), its plain
PyTorch twin, and the wrapper that picks between them by device.

Replaces ``stereo_reconstruction_tpu/ops/pallas_block_search.py::_kernel``
(``pallas_block_search_right``): the whole Right-variant search in one
kernel, approximate by design. The image is cut into W tiles of
``TW = min(tile_width, round_up(W, 128))`` columns, and the tile
boundaries are part of the result. Tile by tile, row by row:

* the up-neighbour discount against the row above's final (black-zeroed)
  disparity in the same column, from row 1 on;
* sweep 0 with no left neighbour, then ``row_smooth_iters - 1`` Jacobi
  sweeps whose left neighbour is the previous sweep's disparity before
  black zeroing; column 0 of tile wt > 0 takes tile wt-1's final
  disparity of the same row;
* a first-index argmin, ``-x`` where no cost is finite, black right pixels
  zeroed once after the last sweep.

A discount multiplies the cost of the candidate ``d == sign * neighbour``
by ``smooth_factor``: sign -1 in mode ``"reference"`` (the reference's
sign quirk), +1 in ``"intended"``, no discount in ``"none"``. This is not
the exact recurrence of ``ops/smoothing.py``.

The wrapper takes the plain twin only for CPU tensors. A CUDA tensor
launches the kernel or raises; nothing falls back. ``min_disparity < 0``
raises ``ValueError`` on every device.
"""

from __future__ import annotations

import torch

from stereo_reconstruction_tpu_torch.config import MatcherConfig
from stereo_reconstruction_tpu_torch.ops.cost_volume import (
    black_pixel_mask,
    cost_volume_right_ssd,
)
from stereo_reconstruction_tpu_torch.ops.cuda_cost_volume import cuda_images

# kernel launches made by ``block_search_fused`` (the plain twin never counts)
LAUNCHES = 0

SMOOTH_SIGN = {"reference": -1, "intended": 1, "none": 0}

# the kernel's one CTA has a thread per tile column
MAX_TILE_WIDTH = 1024


def tile_width_for(w: int, tile_width: int) -> int:
    """The TPU kernel's tile width: ``min(tile_width, round_up(W, 128))``."""
    return min(tile_width, -(-w // 128) * 128)


def _check(config: MatcherConfig, smooth_mode: str) -> None:
    if smooth_mode not in SMOOTH_SIGN:
        raise ValueError(f"unknown smooth_mode {smooth_mode!r}")
    if config.min_disparity < 0:
        raise ValueError("K3 needs min_disparity >= 0")
    if config.max_disparity <= config.min_disparity:
        raise ValueError(f"empty disparity range [{config.min_disparity}, "
                         f"{config.max_disparity})")
    if config.block_size < 3:
        raise ValueError(f"K3 needs block_size >= 3, got {config.block_size}")


def block_search_fused_plain(left, right, config: MatcherConfig = MatcherConfig(),
                             tile_width: int = 512,
                             smooth_mode: str = "reference") -> torch.Tensor:
    """K3's recurrence in plain PyTorch on the full cost volume; (H, W)
    float32 disparity of the right image."""
    _check(config, smooth_mode)
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    h, w = right.shape[:2]
    min_d = config.min_disparity
    cost = cost_volume_right_ssd(left, right, config.block_size, min_d,
                                 config.max_disparity)
    black = black_pixel_mask(right)
    dev = right.device
    f32 = torch.float32
    sf = torch.tensor(config.smooth_factor, dtype=f32, device=dev)
    dvals = (min_d + torch.arange(cost.shape[0], device=dev)).to(f32)[:, None]
    sign = SMOOTH_SIGN[smooth_mode]
    nan = torch.full((1,), float("nan"), dtype=f32, device=dev)
    tw = tile_width_for(w, tile_width)

    def resolve(c, neighbour, sentinel):
        if sign and neighbour is not None:
            c = torch.where(dvals == sign * neighbour, c * sf, c)
        best, idx = torch.min(c, dim=0)
        return torch.where(torch.isfinite(best), idx.to(f32) + min_d, sentinel)

    out = torch.empty((h, w), dtype=f32, device=dev)
    for x0 in range(0, w, tw):
        x1 = min(x0 + tw, w)
        sentinel = -torch.arange(x0, x1, device=dev).to(f32)
        prev = None
        for y in range(h):
            # the up-neighbour discount is part of the cost every sweep sees
            c = cost[:, y, x0:x1]
            if sign and prev is not None:
                c = torch.where(dvals == sign * prev, c * sf, c)
            disp = resolve(c, None, sentinel)
            first = out[y, x0 - 1:x0] if x0 > 0 else nan
            for _ in range(config.row_smooth_iters - 1):
                disp = resolve(c, torch.cat([first, disp[:-1]]), sentinel)
            disp = torch.where(black[y, x0:x1], torch.zeros((), dtype=f32, device=dev),
                               disp)
            out[y, x0:x1] = disp
            prev = disp
    return out


def block_search_fused(left, right, config: MatcherConfig = MatcherConfig(),
                       tile_width: int = 512,
                       smooth_mode: str = "reference") -> torch.Tensor:
    """Right-image disparity, (H, W) float32, of left (H, W_l, 3) and right
    (H, W, 3) images by the fused search: the plain twin for CPU tensors,
    K3 for CUDA tensors."""
    global LAUNCHES
    if left.device.type == "cpu" and right.device.type == "cpu":
        return block_search_fused_plain(left, right, config, tile_width, smooth_mode)
    _check(config, smooth_mode)
    left, right, D = cuda_images(left, right, config.min_disparity,
                                 config.max_disparity, "K3")
    h, w = right.shape[:2]
    tw = tile_width_for(w, tile_width)
    if not 1 <= tw <= MAX_TILE_WIDTH:
        raise ValueError(f"K3 needs a tile width in [1, {MAX_TILE_WIDTH}], got {tw}")
    from stereo_reconstruction_tpu_torch.kernels.build import load_library

    lib = load_library()
    hbs = (config.block_size - 1) // 2
    f32 = dict(dtype=torch.float32, device=right.device)
    disp = torch.empty((h, w), **f32)
    ring = torch.empty((2 * hbs, D, tw), **f32)
    cst = torch.empty((D, tw), **f32)
    boundary = torch.empty((h,), **f32)
    colsum = torch.empty((D, tw), dtype=torch.float64, device=right.device)
    stream = torch.cuda.current_stream(right.device).cuda_stream
    with torch.cuda.device(right.device):
        rc = lib.stpu_block_search(
            left.data_ptr(), right.data_ptr(), disp.data_ptr(), ring.data_ptr(),
            cst.data_ptr(), boundary.data_ptr(), colsum.data_ptr(), h, w,
            left.shape[1], hbs, config.min_disparity, D, tw, config.smooth_factor,
            SMOOTH_SIGN[smooth_mode], config.row_smooth_iters, stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc}")
    LAUNCHES += 1
    return disp
