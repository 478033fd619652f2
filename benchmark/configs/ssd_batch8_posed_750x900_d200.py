"""Plain reference of ``ssd_batch8_posed_750x900_d200``: ``pair(left,
right, K, F, pipeline, device, batch_shape, low=False)`` is one pair of a
padded batch through the calibrated SSD chain of
``benchmark/reference/stereo.py`` (rectification by F, the block search
with its smoothing recurrence, the back-warp, the outlier clamp, depth),
with the homographies of ``benchmark/reference/loop_zhang_scaled.py``.

The padding rule of a batch: every image is zero-padded at its bottom and
right to the batch's largest height rounded up to a multiple of 8 and its
largest width rounded up to a multiple of 128; the canvas is that of the
padded shape, Loop-Zhang takes the pair's true shape, and the back-warp,
the clamp and depth run on the padded frame. F is the one the program's
pose stage found for the pair; ``F=None`` (a pair whose pose was not
used) warps with identity homographies.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from benchmark.reference.loop_zhang_scaled import loop_zhang_homographies
from benchmark.reference.stereo import (
    box_blur,
    smoothed_disparity,
    ssd_cost_volume,
    static_canvas,
    warp_bilinear,
    warp_nearest,
)


def padded_shape(batch_shape: Tuple[int, int]) -> Tuple[int, int]:
    """The padded (rows, cols) of a batch whose largest image is
    ``batch_shape``."""
    h, w = batch_shape
    return h + (-h) % 8, w + (-w) % 128


def pair(left: np.ndarray, right: np.ndarray, K_right: np.ndarray, F: Optional[np.ndarray],
         pipeline: dict, device, batch_shape: Tuple[int, int], low: bool = False):
    """(disparity, depth), float32 NumPy on the padded frame, of the pair
    (uint8 (H, W, 3) images) in a batch whose largest image is
    ``batch_shape``, rectified by F under the settings of ``pipeline``;
    ``low=True`` is the control (bfloat16 images and costs, the blur
    summed in float32)."""
    m, rc = pipeline["matcher"], pipeline["recon"]
    h, w = right.shape[:2]
    hp, wp = padded_shape(batch_shape)
    if F is None:
        H_left = H_right = np.eye(3)
    else:
        H_left, H_right = loop_zhang_homographies(F, (h, w), (h, w))
    canvas = static_canvas(hp, wp, pipeline["rectify"]["canvas_scale"])

    def padded(image):
        out = torch.zeros((hp, wp, image.shape[2]), dtype=torch.uint8, device=device)
        out[:h, :w] = torch.as_tensor(image, device=device)
        return out

    lr = warp_bilinear(padded(left), H_left, canvas)
    rr = warp_bilinear(padded(right), H_right, canvas)
    black = (rr == 0).all(-1)
    if low:
        lr, rr = (t.to(torch.bfloat16).to(torch.float32) for t in (lr, rr))
    cost = ssd_cost_volume(lr, rr, m["block_size"], m["min_disparity"], m["max_disparity"])
    if low:
        cost = cost.to(torch.bfloat16).to(torch.float32)
    disp_rect = smoothed_disparity(cost, black, m["min_disparity"], m["smooth_factor"])
    del cost
    disp = warp_nearest(disp_rect, H_right, (hp, wp))
    blurred = box_blur(disp, rc["outlier_kernel"], torch.float32 if low else torch.float64)
    outlier = (disp > rc["outlier_front"] * blurred) | (disp < rc["outlier_back"] * blurred)
    clean = torch.where(outlier, blurred, disp)
    fb = (torch.tensor(float(K_right[0, 0]), dtype=torch.float32)
          * torch.tensor(rc["baseline"], dtype=torch.float32)).to(device)
    depth = torch.where(clean == 0, -math.inf, fb / torch.where(clean == 0, 1.0, clean))
    return disp.cpu().numpy(), depth.cpu().numpy()
