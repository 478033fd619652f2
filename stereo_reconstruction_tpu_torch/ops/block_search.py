"""Dense window-search disparity, Right variant (reference
BlockSearch::computeDisparityMapRight, BlockSearch.cpp:88-179).

Port of ``stereo_reconstruction_tpu/ops/block_search.py::block_search_right``
for the SSD cost with ``min_disparity >= 0`` (a negative one raises on
every backend: the JAX reference is wrong there, ROADMAP Queue 3):

  * kernel backend: K1 (``ops/cuda_cost_volume.py``) emits the five
    smoothing-scan planes directly, then K1b (``ops/cuda_row_scan.py``)
    runs the exact row scan;
  * plain backend: the full cost volume (``ops/cost_volume.py``), its
    reductions, then the same row scan.

Both give the same disparity wherever the window sums are exact.
"""

from __future__ import annotations

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
    if config.cost != "ssd" or config.var_block:
        raise NotImplementedError(
            f"cost={config.cost!r}, var_block={config.var_block} not ported yet")
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
    if kernel:
        planes = ccv.matcher_inputs(left, right, config.block_size,
                                    config.min_disparity, config.max_disparity)
        return crs.row_scan(
            *planes, black, smooth_factor=config.smooth_factor,
            d_first=config.min_disparity,
            n_planes=config.max_disparity - config.min_disparity,
        )
    cost = cv.cost_volume_right_ssd(left, right, config.block_size,
                                    config.min_disparity, config.max_disparity)
    return smoothing.smoothed_argmin_reference(
        cost, black, smooth_factor=config.smooth_factor,
        d_first=config.min_disparity)
