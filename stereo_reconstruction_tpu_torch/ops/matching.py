"""Descriptor matching: Gram distances, Lowe ratio, mutual check.

Port of ``stereo_reconstruction_tpu/ops/matching.py``:

  * ``match_descriptors`` (the reference's FLANN kNN matcher,
    ``src/PoseEstimation/keypoints.cpp:12-24``): all pairwise squared
    distances from one (K x K) Gram matmul, the 2-NN ratio test and the
    optional mutual-nearest check;
  * ``match_descriptors_binary`` (``cv::BFMatcher(NORM_HAMMING, true)``,
    ``src/rectification_main.cpp:85``): Hamming distances of {0,1}
    descriptors from one Gram matmul (exact in float32 with TF32 off),
    the nearest match and the cross-check;
  * the duplicate-position filter of ``uniqueColumnsInMatrix``
    (utils.cpp:77-95: the first match per near-identical left position
    survives), ``matches_to_homogeneous`` and ``valid_first``.
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


def match_descriptors_binary(kp_left: Keypoints, kp_right: Keypoints) -> Matches:
    """Brute-force Hamming matching with the mutual cross-check, no ratio
    test. Descriptors are {0,1} float matrices, so Hamming(a, b) = |a| +
    |b| - 2 a.b; ties go to the lower index."""
    dl = kp_left.descriptors                       # (K, bits) in {0,1}
    dr = kp_right.descriptors
    K = dl.shape[0]
    ham = (torch.sum(dl, dim=1)[:, None] + torch.sum(dr, dim=1)[None, :]
           - 2.0 * (dl @ dr.T))
    ham = torch.where(kp_right.valid[None, :], ham, torch.inf)
    nn = torch.argmin(ham, dim=1)                  # left -> right
    d1 = torch.gather(ham, 1, nn[:, None])[:, 0]
    # crossCheck=true: keep (i, j) only if i is also j's nearest left
    back = torch.argmin(torch.where(kp_left.valid[:, None], ham, torch.inf), dim=0)
    valid = (kp_left.valid & torch.isfinite(d1)
             & (back[nn] == torch.arange(K, device=dl.device)))
    return Matches(left_xy=kp_left.xy, right_xy=kp_right.xy[nn], distance=d1,
                   valid=_filter_duplicate_positions(kp_left.xy, valid))


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


def valid_first(matches: Matches):
    """``matches_to_homogeneous`` with the valid matches moved to the
    front in their original order: (3, M) left, (3, M) right, and how many
    are valid (a 0-d tensor)."""
    left, right, valid = matches_to_homogeneous(matches)
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    return left[:, order], right[:, order], torch.sum(valid)
