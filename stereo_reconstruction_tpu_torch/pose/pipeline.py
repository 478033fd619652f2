"""Sparse pose estimation: RANSAC eight-point -> outlier filter -> LM BA.

Port of ``stereo_reconstruction_tpu/pose/pipeline.py`` (reference
``runFullPoseEstimation``, ``src/PoseEstimation/pose_estimation.cpp:
4-115``) over a fixed match count N with ``n_valid`` valid matches at the
front, ``n_valid`` staying a tensor throughout:

1. parallel-hypothesis RANSAC;
2. all matches triangulated under the RANSAC pose and filtered by
   ``error > 2 * mean OR depth < 0`` (pose_estimation.cpp:44-72);
3. the first ``ba.num_points`` survivors, padded with zero-weight dummy
   points where fewer survive (``enough_points`` is the reference's
   would-be throw, pose_estimation.cpp:77-89);
4. bundle adjustment, and both stages' mean reprojection errors
   (pose_estimation.cpp:99-101).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stereo_reconstruction_tpu_torch.config import PipelineConfig
from stereo_reconstruction_tpu_torch.ops import geometry as geo
from stereo_reconstruction_tpu_torch.pose.ba import bundle_adjust
from stereo_reconstruction_tpu_torch.pose.ransac import ransac_eight_point


class PoseEstimate(NamedTuple):
    pose: torch.Tensor             # (4, 4) BA-refined pose
    pose_ransac: torch.Tensor      # (4, 4) eight-point/RANSAC pose
    fundamental: torch.Tensor      # (3, 3) F from the BA pose
    keypoints_left: torch.Tensor   # (3, M) the BA support set (padded)
    keypoints_right: torch.Tensor  # (3, M)
    weights: torch.Tensor          # (M,) 1 = real point, 0 = padding
    reproj_error_8pt: torch.Tensor  # () mean reprojection error, 8pt stage
    reproj_error_ba: torch.Tensor   # () mean reprojection error, after BA
    num_inliers: torch.Tensor      # () filtered survivor count
    enough_points: torch.Tensor    # () bool: >= ba.num_points survivors
    valid: torch.Tensor            # () bool: RANSAC produced a valid pose


def estimate_pose_from_matches(
    matches_left: torch.Tensor,    # (3, N) homogeneous pixel coords
    matches_right: torch.Tensor,   # (3, N)
    K_left: torch.Tensor,
    K_right: torch.Tensor,
    config: PipelineConfig = PipelineConfig(),
    num_matches_valid=None,        # int or 0-d tensor (None -> all N)
    uniforms: Optional[torch.Tensor] = None,    # RANSAC draws, see ransac.py
) -> PoseEstimate:
    device = matches_left.device
    n = matches_left.shape[-1]
    n_valid = torch.as_tensor(n if num_matches_valid is None else num_matches_valid,
                              device=device)
    m = config.ba.num_points

    rr = ransac_eight_point(matches_left, matches_right, K_left, K_right,
                            config.ransac, n_valid, uniforms)
    R, T = rr.rotation, rr.translation

    # triangulate all matches under the RANSAC pose (pose_estimation.cpp:
    # 44-53); columns past n_valid become copies of the first match, since
    # the joint depth solve couples every column
    in_range = torch.arange(n, device=device) < n_valid
    safe_left = torch.where(in_range[None, :], matches_left, matches_left[:, :1])
    safe_right = torch.where(in_range[None, :], matches_right, matches_right[:, :1])
    xl = geo.normalize_points(K_left, safe_left)
    xr = geo.normalize_points(K_right, safe_right)
    depths = geo.triangulate_depths(xl, xr, R, T)
    pts_left = xl * depths[None, :]
    errors = geo.pixel_error(geo.project(K_right, geo.transform(R, T, pts_left)),
                             matches_right)

    # the reference's throw condition counts UNIQUE match columns
    # (uniqueColumnsInMatrix, utils.cpp:50-95, before eight_point.cpp:176-184)
    col = torch.cat([matches_left, matches_right], dim=0)            # (6, N)
    eq = torch.all(col[:, :, None] == col[:, None, :], dim=0)        # (N, N)
    ii = torch.arange(n, device=device)
    dup_of_earlier = torch.any(eq & (ii[None, :] < ii[:, None]) & in_range[None, :], dim=1)
    n_unique = torch.sum(in_range & ~dup_of_earlier)
    mean_err = (torch.sum(torch.where(in_range, errors, 0.0))
                / torch.clamp_min(n_valid, 1))
    keep = in_range & (errors <= 2.0 * mean_err) & (depths >= 0)
    num_survivors = torch.sum(keep)

    # the first M survivors in their original order
    sel = torch.argsort((~keep).to(torch.int8), stable=True)[:m]
    weights = keep[sel].to(torch.float32)
    real = weights[None, :] > 0
    # padded slots get a dummy point in front of both cameras
    dummy = torch.tensor([[0.0], [0.0], [1.0]], device=device)
    pts0 = torch.where(real, pts_left[:, sel], dummy)
    kp_l = torch.where(real, matches_left[:, sel], geo.project(K_left, dummy))
    kp_r = torch.where(real, matches_right[:, sel],
                       geo.project(K_right, geo.transform(R, T, dummy)))

    result = bundle_adjust(kp_l, kp_r, K_left, K_right, R, T, pts0,
                           weights=weights, config=config.ba)
    err_8pt = _masked_reconstruction_error(kp_l, kp_r, K_left, K_right, R, T, pts0,
                                           weights)
    err_ba = _masked_reconstruction_error(kp_l, kp_r, K_left, K_right, result.rotation,
                                          result.translation, result.points, weights)
    return PoseEstimate(
        pose=result.pose,
        pose_ransac=rr.pose,
        fundamental=result.fundamental,
        keypoints_left=kp_l,
        keypoints_right=kp_r,
        weights=weights,
        reproj_error_8pt=err_8pt,
        reproj_error_ba=err_ba,
        num_inliers=num_survivors,
        enough_points=num_survivors >= m,
        # non-finite reprojection errors (degenerate triangulation, diverged
        # BA) or fewer than 8 unique matches make the pose invalid
        valid=rr.valid & torch.isfinite(err_8pt) & torch.isfinite(err_ba)
        & (n_unique >= 8),
    )


def _masked_reconstruction_error(kp_l, kp_r, K_l, K_r, R, T, pts, w):
    """Weighted two-view mean reprojection error over the 3-row homogeneous
    difference (reference averageReconstructionError, utils.cpp:98-120)."""
    nw = torch.clamp_min(torch.sum(w), 1.0)
    err_l = torch.sum(geo.column_norm(geo.project(K_l, pts) - kp_l) * w) / nw
    pts_r = geo.transform(R, T, pts)
    err_r = torch.sum(geo.column_norm(geo.project(K_r, pts_r) - kp_r) * w) / nw
    return (err_l + err_r) / 2.0
