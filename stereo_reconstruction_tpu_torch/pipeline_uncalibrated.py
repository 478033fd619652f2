"""Uncalibrated rectification pipeline (the reference's second frontend).

Port of ``stereo_reconstruction_tpu/pipeline_uncalibrated.py``
(``src/rectification_main.cpp:157-217``): detect and match features,
estimate F directly by RANSAC (no intrinsics), rectify with Loop-Zhang,
run the linear (1x1) search, and re-estimate F on the rectified matches.
The detectors are ORB (FAST/Harris/rBRIEF, the reference's default) and
BRISK with brute-force Hamming cross-check matching
(``ops/binary_features.py``, ``ops/matching.py``), or the calibrated
path's DoG/SIFT frontend with L2 ratio matching (``detector="dog"``).

It runs on the card (``device="cuda"``) unless the caller asks for the
CPU; without a card it raises. The RANSAC draws are an input (``samples``,
see ``pose/fundamental.py``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from stereo_reconstruction_tpu_torch.config import PipelineConfig
from stereo_reconstruction_tpu_torch.ops.binary_features import (
    detect_and_describe_brisk,
    detect_and_describe_orb,
)
from stereo_reconstruction_tpu_torch.ops.features import detect_and_describe
from stereo_reconstruction_tpu_torch.ops.linear_search import linear_search
from stereo_reconstruction_tpu_torch.ops.matching import (
    match_descriptors,
    match_descriptors_binary,
    matches_to_homogeneous,
)
from stereo_reconstruction_tpu_torch.pipeline import _device
from stereo_reconstruction_tpu_torch.pose.fundamental import (
    draw_samples,
    ransac_fundamental,
)
from stereo_reconstruction_tpu_torch.rectify.rectifier import rectify_pair

# hypotheses per RANSAC (ransac_fundamental's default in the JAX package)
NUM_HYPOTHESES = 128


@dataclasses.dataclass
class UncalibratedResult:
    F: np.ndarray                       # estimated fundamental matrix
    F_rectified: Optional[np.ndarray]   # F re-estimated on the rectified pair
    disparity: np.ndarray               # (Hc, Wc) linear-search disparity
    rectified_left: np.ndarray
    rectified_right: np.ndarray
    num_inliers: int
    # rectification quality: mean |y_left - y_right| of the F-inlier matches
    # after the Loop-Zhang warps (rectified matches share scanlines)
    epipolar_alignment_px: float = float("nan")


def _image(img, device: torch.device) -> torch.Tensor:
    """An image on ``device``: float64 becomes float32, other dtypes stay."""
    t = torch.as_tensor(np.asarray(img))
    return (t.to(torch.float32) if t.dtype == torch.float64 else t).to(device)


def run_uncalibrated(
    image_left,
    image_right,
    config: PipelineConfig = PipelineConfig(),
    samples: Optional[Sequence[torch.Tensor]] = None,
    detector: str = "orb",
    output_dir: Optional[str] = None,
    device="cuda",
) -> UncalibratedResult:
    """F, rectified pair and linear-search disparity of an uncalibrated pair.

    ``detector``: "orb" (the reference's default,
    rectification_main.cpp:126-129), "brisk" (its alternative,
    rectification_main.cpp:46-51) or "dog". ``samples``: the two RANSAC
    draws (``pose.fundamental.draw_samples``), the first for F and the
    second for the re-estimation on the rectified matches; by default both
    come from one CPU generator seeded with ``config.seed``, in that order.
    ``output_dir``: when given, the rectified pair with rendered epilines
    and the disparity map are written there as PNGs
    (rectification_main.cpp:204-214)."""
    device = _device(device)
    left, right = _image(image_left, device), _image(image_right, device)
    if detector in ("orb", "brisk"):
        detect = detect_and_describe_orb if detector == "orb" else detect_and_describe_brisk
        cfg = config.orb if detector == "orb" else config.brisk
        matches = match_descriptors_binary(detect(left, cfg), detect(right, cfg))
    elif detector == "dog":
        matches = match_descriptors(detect_and_describe(left, config.frontend),
                                    detect_and_describe(right, config.frontend),
                                    config.frontend)
    else:
        raise ValueError(f"unknown detector {detector!r}: orb, brisk or dog")
    ml, mr, valid = matches_to_homogeneous(matches)

    # valid matches to the front, in their original order
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    ml, mr = ml[:, order], mr[:, order]
    n_valid = int(valid.sum())
    generator = torch.Generator().manual_seed(config.seed)

    def draws(i, n):
        return (samples[i] if samples is not None
                else draw_samples(NUM_HYPOTHESES, n, generator))

    fr = ransac_fundamental(ml, mr, draws(0, n_valid), num_matches_valid=n_valid)
    F = fr.F.cpu().numpy().astype(np.float64)
    inl = fr.inlier_mask
    n_inl = int(inl.sum())
    rect = rectify_pair(left, right, F, matches_left=ml[:, inl], matches_right=mr[:, inl],
                        config=config.rectify)
    disparity = linear_search(rect.left, rect.right,
                              smooth_factor=config.matcher.smooth_factor,
                              search_range=config.matcher.max_disparity)

    # re-estimate F on the rectified matches (rectification_main.cpp:199-202)
    F_rect = None
    if n_valid >= 8:
        ones = torch.ones_like(rect.matches_left[:1])
        fr2 = ransac_fundamental(torch.cat([rect.matches_left, ones]),
                                 torch.cat([rect.matches_right, ones]),
                                 draws(1, n_inl), num_matches_valid=n_inl)
        F_rect = fr2.F.cpu().numpy().astype(np.float64)
    rml, rmr = rect.matches_left.cpu().numpy(), rect.matches_right.cpu().numpy()
    align = float(np.mean(np.abs(rml[1] - rmr[1]))) if n_inl > 0 else float("nan")

    result = UncalibratedResult(
        F=F,
        F_rectified=F_rect,
        disparity=disparity.cpu().numpy(),
        rectified_left=rect.left.cpu().numpy(),
        rectified_right=rect.right.cpu().numpy(),
        num_inliers=int(fr.num_inliers),
        epipolar_alignment_px=align,
    )
    if output_dir:
        from stereo_reconstruction_tpu_torch.io.image import write_image
        from stereo_reconstruction_tpu_torch.rectify.epilines import draw_rectified_epilines

        os.makedirs(output_dir, exist_ok=True)
        el, er = result.rectified_left, result.rectified_right
        if F_rect is not None:
            el, er = draw_rectified_epilines(el, er, F_rect, rml.T, rmr.T)
        write_image(os.path.join(output_dir, "rectified_left.png"), el)
        write_image(os.path.join(output_dir, "rectified_right.png"), er)
        write_image(os.path.join(output_dir, "disparity_linear.png"), result.disparity)
    return result
