"""Rectify a stereo pair and bridge disparity back to the original frame.

Port of ``stereo_reconstruction_tpu/rectify/rectifier.py`` (reference
``ImageRectifier``, rectification.cpp:53-88,432-497): Loop-Zhang
homographies on the host (float64 NumPy), warps into a static canvas on
the images' device, and the nearest-neighbour back-warp of disparity.
Every inverse map is computed on the host (``ops/warp.py::host_inverse``),
so on the card the two rectifying warps are one launch of the warp kernel
and the back-warp another, with no upload and no synchronisation.

The canvas is ``ceil(canvas_scale * input)``, height rounded up to a
multiple of 8 and width to a multiple of 128, exactly as in the JAX
package: right-edge candidate validity in the matcher depends on the
canvas width, so another canvas would change the disparity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from stereo_reconstruction_tpu_torch.config import RectifyConfig
from stereo_reconstruction_tpu_torch.ops.warp import host_inverse, transform_points, \
    warp_perspective
from stereo_reconstruction_tpu_torch.rectify.loop_zhang import (
    RectifyHomographies,
    loop_zhang_homographies,
)
from stereo_reconstruction_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class RectifiedPair:
    left: torch.Tensor            # (Hc, Wc, 3) rectified left image
    right: torch.Tensor           # (Hc, Wc, 3) rectified right image
    homographies: RectifyHomographies
    matches_left: Optional[torch.Tensor] = None    # (2, N) rectified matches
    matches_right: Optional[torch.Tensor] = None
    canvas: Tuple[int, int] = (0, 0)               # static canvas used


def static_canvas(
    shape_left, shape_right, config: RectifyConfig, lane: int = 128
) -> Tuple[int, int]:
    h = max(shape_left[0], shape_right[0])
    w = max(shape_left[1], shape_right[1])
    hc = int(np.ceil(h * config.canvas_scale))
    wc = int(np.ceil(w * config.canvas_scale))
    return (hc + (-hc) % 8, wc + (-wc) % lane)


def rectify_pair(
    image_left: torch.Tensor,
    image_right: torch.Tensor,
    F: np.ndarray,
    matches_left: Optional[torch.Tensor] = None,   # (2 or 3, N) pixel coords
    matches_right: Optional[torch.Tensor] = None,
    config: RectifyConfig = RectifyConfig(),
) -> RectifiedPair:
    with span("rectify.homographies"):
        homs = loop_zhang_homographies(
            np.asarray(F, np.float64),
            tuple(image_left.shape[:2]),
            tuple(image_right.shape[:2]),
        )
        canvas = static_canvas(image_left.shape, image_right.shape, config)
    device = image_left.device
    with span("rectify.warp"):
        ml = mr = None
        if matches_left is not None:
            Hl = torch.as_tensor(homs.H_left, dtype=torch.float32, device=device)
            Hr = torch.as_tensor(homs.H_right, dtype=torch.float32, device=device)
            ml = transform_points(Hl, torch.as_tensor(matches_left, dtype=torch.float32,
                                                      device=device)[:2])
            mr = transform_points(Hr, torch.as_tensor(matches_right, dtype=torch.float32,
                                                      device=device)[:2])
        if image_left.shape[2:] == image_right.shape[2:]:
            warped_left, warped_right = warp_perspective(
                [image_left, image_right], np.stack([homs.H_left, homs.H_right]), canvas)
        else:                   # the sides differ in channels: a warp each
            warped_left = warp_perspective(image_left, homs.H_left, canvas)
            warped_right = warp_perspective(image_right, homs.H_right, canvas)

    return RectifiedPair(
        left=warped_left,
        right=warped_right,
        homographies=homs,
        matches_left=ml,
        matches_right=mr,
        canvas=canvas,
    )


def disparity_to_original_frame(
    disparity_rect: torch.Tensor,     # (Hc, Wc) disparity in rectified frame
    H: np.ndarray,                    # homography used for that image
    out_shape: Tuple[int, int],       # original (H, W)
    compat_left_homography: Optional[np.ndarray] = None,
) -> torch.Tensor:
    """Nearest-neighbour back-warp of disparity *values* (the reference's
    approximation: values are resampled, not re-projected;
    rectification.cpp:70-88). ``compat_left_homography`` restores the
    reference's use of the left homography."""
    Hu = compat_left_homography if compat_left_homography is not None else H
    # dst(p) = src(Hu p): warpPerspective with M = Hu^{-1}
    return warp_perspective(disparity_rect, host_inverse(np.asarray(Hu, np.float64)),
                            out_shape, method="nearest")
