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

Where a discounted cost of a column is NaN (``+inf * 0`` at
``smooth_factor`` 0), ``torch.min`` lets the NaN win and the column takes
its sentinel ``-x`` for that sweep, as ``jnp.min`` does in the TPU kernel.

K3 is a parallel cost pass over all tiles (K1's window-cost routine,
storing the volume and each pixel's three smallest costs) and a row chain
in one CTA (``csrc/block_search.cuh``); the call's three launches (the
left layout pass, the two kernels) count as one K3 launch. Its scratch is
the (D, H, W) float32 volume, D*H*W*4 bytes (1.27 GB at 1128x1408,
D=200), plus (6, H, W) for the top three, the layout pass's 3*H*W_pad
floats and 8*W + n_tiles floats for the chain. K3 takes block sizes 3 to
17, D up to 65535 (16-bit plane indices; ``ValueError`` beyond, before any
launch), any width and any tile width.

The wrapper takes the plain twin only for CPU tensors. A CUDA tensor
launches the kernel or raises; nothing falls back. ``min_disparity < 0``
raises ``ValueError`` on every device.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_reconstruction_tpu_torch.config import MatcherConfig
from stereo_reconstruction_tpu_torch.kernels.launch import entry, launch, on_card
from stereo_reconstruction_tpu_torch.ops.cost_volume import (
    black_pixel_mask,
    cost_volume_right_ssd,
)
from stereo_reconstruction_tpu_torch.ops.cuda_cost_volume import (
    cuda_images,
    window_cost_setup,
)

_p, _i = ctypes.c_void_p, ctypes.c_int
_block_search = entry("stpu_block_search", [_p] * 7 + [_i] * 8 + [ctypes.c_float, _i, _i, _p],
                      _i)
# K3's plane indices are 16-bit, 0xffff marking an empty top-3 slot
# (``kNoPlane``, csrc/block_search.cuh)
MAX_PLANES = 0xffff

SMOOTH_SIGN = {"reference": -1, "intended": 1, "none": 0}


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
    if not on_card("K3", left, right):
        return block_search_fused_plain(left, right, config, tile_width, smooth_mode)
    _check(config, smooth_mode)
    left, right, D = cuda_images(left, right, config.min_disparity,
                                 config.max_disparity, "K3", MAX_PLANES)
    h, w = right.shape[:2]
    tw = tile_width_for(w, tile_width)
    if tw < 1:
        raise ValueError(f"K3 needs a tile width >= 1, got {tw}")
    hbs, wl_pad, layout = window_cost_setup(left, right, config.block_size,
                                            config.min_disparity, D, "K3")
    f32 = dict(dtype=torch.float32, device=right.device)
    disp = torch.empty((h, w), **f32)
    cost = torch.empty((D, h, w), **f32)
    top = torch.empty((6, h, w), **f32)
    rows = torch.empty((8 * w + -(-w // tw),), **f32)
    launch("K3", _block_search, right.device,
           left.data_ptr(), right.data_ptr(), disp.data_ptr(), cost.data_ptr(),
           top.data_ptr(), layout.data_ptr(), rows.data_ptr(), h, w, left.shape[1],
           wl_pad, hbs, config.min_disparity, D, tw, config.smooth_factor,
           SMOOTH_SIGN[smooth_mode], config.row_smooth_iters)
    return disp
