"""Descriptor matching: Gram distances, Lowe ratio, mutual check.

Port of ``match_descriptors`` and ``matches_to_homogeneous`` of
``stereo_reconstruction_tpu/ops/matching.py`` (the reference's FLANN kNN
matcher, ``src/PoseEstimation/keypoints.cpp:12-24``): all pairwise
squared distances from one (K x K) Gram matmul, the 2-NN ratio test,
the optional mutual-nearest check, and the duplicate-position filter of
``uniqueColumnsInMatrix`` (utils.cpp:77-95: the first match per
near-identical left position survives).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_reconstruction_tpu_torch.config import FrontendConfig
from stereo_reconstruction_tpu_torch.ops.cost_volume import sqrt_rn
from stereo_reconstruction_tpu_torch.ops.features import Keypoints


class Matches(NamedTuple):
    left_xy: torch.Tensor     # (M, 2) matched left keypoint positions
    right_xy: torch.Tensor    # (M, 2)
    distance: torch.Tensor    # (M,) best descriptor L2 distance
    valid: torch.Tensor       # (M,) bool


def match_descriptors(kp_left: Keypoints, kp_right: Keypoints,
                      config: FrontendConfig = FrontendConfig()) -> Matches:
    dl = kp_left.descriptors                       # (K, 128)
    dr = kp_right.descriptors
    K = dl.shape[0]
    sq = (torch.sum(dl * dl, dim=1)[:, None] + torch.sum(dr * dr, dim=1)[None, :]
          - 2.0 * (dl @ dr.T))
    sq = torch.clamp_min(sq, 0.0)
    # invalid right keypoints are never nearest neighbours
    sq = torch.where(kp_right.valid[None, :], sq, torch.inf)

    # 2-NN per left keypoint, ties to the lower index (lax.top_k)
    top2_val, top2_idx = torch.sort(-sq, dim=1, descending=True, stable=True)
    d1 = sqrt_rn(-top2_val[:, 0])
    d2 = sqrt_rn(torch.clamp_min(-top2_val[:, 1], 0.0))
    nn = top2_idx[:, 0]
    valid = kp_left.valid & (d1 < config.ratio_threshold * d2) & torch.isfinite(d1)

    if config.mutual_check:
        sq_l = torch.where(kp_left.valid[:, None], sq, torch.inf)
        back = torch.argmin(sq_l, dim=0)           # right -> nearest left
        valid = valid & (back[nn] == torch.arange(K, device=dl.device))

    left_xy = kp_left.xy
    return Matches(left_xy=left_xy, right_xy=kp_right.xy[nn], distance=d1,
                   valid=_filter_duplicate_positions(left_xy, valid))


def _filter_duplicate_positions(xy: torch.Tensor, valid: torch.Tensor, tol: float = 1e-4):
    """Keep the first of (near-)duplicate positions (utils.cpp:77-95)."""
    diff = xy[:, None, :] - xy[None, :, :]
    d = sqrt_rn(torch.sum(diff * diff, dim=-1))                      # (K, K)
    ii = torch.arange(xy.shape[0], device=xy.device)
    earlier = ii[:, None] > ii[None, :]                              # j < i
    dup = torch.any((d < tol) & earlier & valid[None, :], dim=1)
    return valid & ~dup


def matches_to_homogeneous(matches: Matches):
    """(3, M) homogeneous column matrices (the reference's
    transformMatchedKeypointsToEigen layout) and the validity mask."""
    ones = torch.ones_like(matches.left_xy[:, :1])
    left = torch.cat([matches.left_xy, ones], dim=1).T
    right = torch.cat([matches.right_xy, ones], dim=1).T
    return left, right, matches.valid
