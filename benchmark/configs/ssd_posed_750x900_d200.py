"""Plain reference of ``ssd_posed_750x900_d200``: ``pair(left, right, K,
F, pipeline, device, low=False)`` is the calibrated SSD chain of
``benchmark/reference/stereo.py::ssd_pair`` (rectification by F, the
block search with its smoothing recurrence, the back-warp, the outlier
clamp, depth) with the homographies of
``benchmark/reference/loop_zhang_scaled.py``, whose tolerant Cholesky
takes the F a sound pose gives. F is the one the program's pose stage
found; the pose itself is held to the truth by the entry's check."""

from __future__ import annotations

import math

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


def pair(left: np.ndarray, right: np.ndarray, K_right: np.ndarray, F: np.ndarray,
         pipeline: dict, device, low: bool = False):
    """(disparity, depth), float32 NumPy (H, W), of the pair (uint8 (H, W,
    3) images) rectified by F under the settings of ``pipeline``;
    ``low=True`` is the control (``stereo.ssd_pair``'s)."""
    m, rc = pipeline["matcher"], pipeline["recon"]
    h, w = right.shape[:2]
    H_left, H_right = loop_zhang_homographies(F, (h, w), (h, w))
    canvas = static_canvas(h, w, pipeline["rectify"]["canvas_scale"])
    lr = warp_bilinear(torch.as_tensor(left, device=device), H_left, canvas)
    rr = warp_bilinear(torch.as_tensor(right, device=device), H_right, canvas)
    black = (rr == 0).all(-1)
    if low:
        lr, rr = (t.to(torch.bfloat16).to(torch.float32) for t in (lr, rr))
    cost = ssd_cost_volume(lr, rr, m["block_size"], m["min_disparity"], m["max_disparity"])
    if low:
        cost = cost.to(torch.bfloat16).to(torch.float32)
    disp_rect = smoothed_disparity(cost, black, m["min_disparity"], m["smooth_factor"])
    del cost
    disp = warp_nearest(disp_rect, H_right, (h, w))
    blurred = box_blur(disp, rc["outlier_kernel"], torch.float32 if low else torch.float64)
    outlier = (disp > rc["outlier_front"] * blurred) | (disp < rc["outlier_back"] * blurred)
    clean = torch.where(outlier, blurred, disp)
    fb = (torch.tensor(float(K_right[0, 0]), dtype=torch.float32)
          * torch.tensor(rc["baseline"], dtype=torch.float32)).to(device)
    depth = torch.where(clean == 0, -math.inf, fb / torch.where(clean == 0, 1.0, clean))
    return disp.cpu().numpy(), depth.cpu().numpy()
