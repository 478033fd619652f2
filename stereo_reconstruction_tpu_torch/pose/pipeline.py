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
   (pose_estimation.cpp:99-101). BA runs twice on the same points: from
   RANSAC's winner, and from the best fitting of the hypotheses tied with
   it (``ransac.match_fit``); the second is taken where its pose fits the
   valid matches better by more than ``BA_FIT_SLACK``. JAX runs the first
   only, which from a far winner can settle far off.

``estimate_pose_from_matches`` (step 1, then ``refine_pose``: steps 2-4)
runs one BA round of ``ba.max_iterations`` steps with no host sync, so
``torch.func.vmap`` batches it and a CUDA graph records it
(``pose/graphs.py``). The callers that read the pose
(``pipeline.pose_device``, ``pipeline_batch``) then ``settle_pose``:
further rounds (``ba_round``), outside the vmapped body, while a pose's
BA has not converged (``pose/ba.py``), up to ``BA_ROUNDS`` in all. JAX
runs one round; from a RANSAC winner 2-3 degrees off, one round can end
still descending, more than 1.5 / 10 degrees from the truth.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import vmap

from stereo_reconstruction_tpu_torch.config import PipelineConfig
from stereo_reconstruction_tpu_torch.ops import geometry as geo
from stereo_reconstruction_tpu_torch.pose.ba import BAResult, bundle_adjust
from stereo_reconstruction_tpu_torch.pose.ransac import RansacResult, match_fit, ransac_eight_point
from stereo_reconstruction_tpu_torch.utils.profiling import span


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
    points: torch.Tensor           # (3, M) BA-refined points (left frame)
    ba_converged: torch.Tensor     # () bool: BA's cost settled (pose/ba.py)


# BA rounds in all (``settle_pose``): at 750x900 a round of 20 steps left 1
# posed request in ~120 on the card still descending 1.8 / 10.5 degrees off,
# where two more reached the optimum; a 240x320 scene of the tests needs four
BA_ROUNDS = 6


# ``refine_pose`` takes BA's pose from RANSAC's best fitting hypothesis over
# the one from its winner where it fits the valid matches better by more than
# this (``match_fit``, px^2): at 750x900 a winner 3 / 19 degrees off settled
# 3 / 24 degrees off, fitting at 0.76; the best fitting hypothesis, 0.14 /
# 0.76 degrees off, fit at 0.017
BA_FIT_SLACK = 0.25


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
    with span("pose.ransac"):
        rr = ransac_eight_point(matches_left, matches_right, K_left, K_right,
                                config.ransac, n_valid, uniforms)
    with span("pose.ba"):
        return refine_pose(matches_left, matches_right, K_left, K_right, rr, n_valid,
                           config)


def refine_pose(matches_left: torch.Tensor, matches_right: torch.Tensor,
                K_left: torch.Tensor, K_right: torch.Tensor, rr: RansacResult,
                n_valid: torch.Tensor, config: PipelineConfig) -> PoseEstimate:
    """Steps 2-4 from RANSAC's result ``rr``: the outlier filter, one BA
    round and both reprojection errors, with no host sync."""
    device = matches_left.device
    n = matches_left.shape[-1]
    m = config.ba.num_points
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
    dummy = geo.constant(((0.0,), (0.0,), (1.0,)), torch.float32, device)
    pts0 = torch.where(real, pts_left[:, sel], dummy)
    kp_l = torch.where(real, matches_left[:, sel], geo.project(K_left, dummy))
    kp_r = torch.where(real, matches_right[:, sel],
                       geo.project(K_right, geo.transform(R, T, dummy)))

    result = bundle_adjust(kp_l, kp_r, K_left, K_right, R, T, pts0,
                           weights=weights, config=config.ba)
    # BA fits its M points only: from a far RANSAC winner it can settle where
    # they fit and the other matches do not. So BA also runs on the same
    # points from RANSAC's best fitting hypothesis, and that pose is taken
    # where it fits the valid matches better by more than BA_FIT_SLACK
    R_fit, T_fit = rr.fit_pose[:3, :3], rr.fit_pose[:3, 3]
    pts_fit = xl * geo.triangulate_depths(xl, xr, R_fit, T_fit)[None, :]
    other = bundle_adjust(kp_l, kp_r, K_left, K_right, R_fit, T_fit,
                          torch.where(real, pts_fit[:, sel], dummy), weights=weights,
                          config=config.ba)
    threshold = config.ransac.error_threshold
    better = (match_fit(other.fundamental, matches_left, matches_right, n_valid, threshold)
              < match_fit(result.fundamental, matches_left, matches_right, n_valid, threshold)
              - BA_FIT_SLACK)
    result = BAResult(*(torch.where(better, b, a) for a, b in zip(result, other)))
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
        points=result.points,
        ba_converged=result.converged,
    )


def ba_round(kp_left, kp_right, K_left, K_right, pose, points, weights,
             config: PipelineConfig):
    """One further BA round of ``ba.max_iterations`` steps from ``pose``
    and ``points``: (pose, F, points, BA reprojection error, converged)."""
    r = bundle_adjust(kp_left, kp_right, K_left, K_right, pose[:3, :3], pose[:3, 3], points,
                      weights=weights, config=config.ba)
    err = _masked_reconstruction_error(kp_left, kp_right, K_left, K_right, r.rotation,
                                       r.translation, r.points, weights)
    return r.pose, r.fundamental, r.points, err, r.converged


def settle_pose(est: PoseEstimate, K_left: torch.Tensor, K_right: torch.Tensor,
                config: PipelineConfig = PipelineConfig(),
                step: Optional[Callable] = None) -> PoseEstimate:
    """BA continued where it has not converged: while any pose of ``est``
    (one pair's, or a batch's along the first dimension, with intrinsics to
    match) is valid and still descending, one more round of
    ``ba.max_iterations`` steps from where the last ended, the batch's under
    ``torch.func.vmap``, up to ``BA_ROUNDS`` rounds in all. One host read of
    the flags a round; a converged or invalid pose is kept bit for bit, so
    where the first round converges nothing changes and no kernel runs.
    ``step`` runs a round in ``ba_round``'s place with its arguments less
    ``config`` (``pose/graphs.py``)."""

    if step is None:
        def step(*args):
            return ba_round(*args, config)

        if est.pose.dim() == 3:
            step = vmap(step)
    for _ in range(BA_ROUNDS - 1):
        done = est.ba_converged | ~est.valid
        if bool(torch.all(done)):
            break

        def keep(old, new):
            return torch.where(done.reshape(done.shape + (1,) * (new.dim() - done.dim())),
                               old, new)

        with span("pose.ba", est.pose.device):
            pose, F, pts, err, converged = step(
                est.keypoints_left, est.keypoints_right, K_left, K_right, est.pose,
                est.points, est.weights)
            est = est._replace(
                pose=keep(est.pose, pose), fundamental=keep(est.fundamental, F),
                points=keep(est.points, pts), reproj_error_ba=keep(est.reproj_error_ba, err),
                valid=keep(est.valid, est.valid & torch.isfinite(err)),
                ba_converged=keep(est.ba_converged, converged))
    return est


def _masked_reconstruction_error(kp_l, kp_r, K_l, K_r, R, T, pts, w):
    """Weighted two-view mean reprojection error over the 3-row homogeneous
    difference (reference averageReconstructionError, utils.cpp:98-120)."""
    nw = torch.clamp_min(torch.sum(w), 1.0)
    err_l = torch.sum(geo.column_norm(geo.project(K_l, pts) - kp_l) * w) / nw
    pts_r = geo.transform(R, T, pts)
    err_r = torch.sum(geo.column_norm(geo.project(K_r, pts_r) - kp_r) * w) / nw
    return (err_l + err_r) / 2.0
