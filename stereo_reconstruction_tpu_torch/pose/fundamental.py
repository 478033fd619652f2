"""Uncalibrated fundamental-matrix estimation (normalised 8-point + RANSAC).

Port of ``stereo_reconstruction_tpu/pose/fundamental.py``: the reference's
second frontend (``src/rectification_main.cpp:114-155``) estimates F from
matches with ``cv::findFundamentalMat(FM_8POINT | FM_RANSAC, 1.0, 0.99)``,
without intrinsics:

  * the Hartley-normalised 8-point solve (isotropic scaling to mean
    distance sqrt(2)), its null vector by SVD;
  * rank 2 by SVD;
  * parallel-hypothesis RANSAC scored by the Sampson distance at 1 px, a
    refit on the winner's 32 tightest matches kept when it loses no inlier.

The draws are an input: ``samples`` (num_hypotheses, 8) holds each
hypothesis's match indices. JAX draws them with threefry permutations,
which torch cannot reproduce; ``draw_samples`` makes them from a CPU
``torch.Generator`` (the first 8 of a random permutation of the valid
matches), so a CPU run and a CUDA run with the same seed try the same
hypotheses.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from stereo_reconstruction_tpu_torch.ops.cost_volume import sqrt_rn


class FundamentalResult(NamedTuple):
    F: torch.Tensor              # (3, 3), unit Frobenius norm
    inlier_mask: torch.Tensor    # (N,) bool
    num_inliers: torch.Tensor    # () int
    valid: torch.Tensor          # () bool


def draw_samples(num_hypotheses: int, n_valid: int,
                 generator: torch.Generator) -> torch.Tensor:
    """(num_hypotheses, min(8, n_valid)) int64 match indices: the first 8
    of a random permutation of [0, n_valid) per hypothesis, on the CPU."""
    u = torch.rand((num_hypotheses, n_valid), generator=generator)
    return torch.argsort(u, dim=1)[:, :8]


def _normalize_for_8pt(pts: torch.Tensor):
    """Hartley normalisation of (..., 3, N) homogeneous points: translate
    to the centroid, scale the mean distance to sqrt(2). Returns (T pts, T)."""
    xy = pts[..., :2, :]
    centroid = torch.mean(xy, dim=-1, keepdim=True)
    centered = xy - centroid
    mean_dist = torch.mean(sqrt_rn(torch.sum(centered * centered, dim=-2)), dim=-1)
    scale = torch.tensor(math.sqrt(2.0), dtype=pts.dtype,
                         device=pts.device) / torch.clamp_min(mean_dist, 1e-8)
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = scale
    T[..., 1, 1] = scale
    T[..., 0, 2] = -centroid[..., 0, 0] * scale
    T[..., 1, 2] = -centroid[..., 1, 0] * scale
    T[..., 2, 2] = 1.0
    return T @ pts, T


def eight_point_fundamental(matches_left: torch.Tensor,
                            matches_right: torch.Tensor) -> torch.Tensor:
    """Normalised 8-point F of (..., 3, N) homogeneous pixel matches,
    rank 2, unit norm; x_r^T F x_l = 0."""
    xl, Tl = _normalize_for_8pt(matches_left)
    xr, Tr = _normalize_for_8pt(matches_right)
    # rows kron(xl_i, xr_i): element (a, b) multiplies xl_a xr_b
    a = xl.mT[..., :, :, None] * xr.mT[..., :, None, :]   # (..., N, 3, 3)
    chi = a.reshape(*a.shape[:-2], 9)
    f_vec = torch.linalg.svd(chi, full_matrices=True).Vh[..., -1, :]
    Fn = f_vec.reshape(*f_vec.shape[:-1], 3, 3).mT       # F_norm[b, a] = f[3a + b]
    U, S, Vh = torch.linalg.svd(Fn)
    S2 = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    Fn = U @ (S2[..., :, None] * Vh)
    # x = T p, so x_r^T Fn x_l = p_r^T (Tr^T Fn Tl) p_l
    F = Tr.mT @ Fn @ Tl
    norm = sqrt_rn(torch.sum(F * F, dim=(-2, -1), keepdim=True))
    return F / torch.clamp_min(norm, 1e-12)


def sampson_distance(F: torch.Tensor, xl: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) distance per match, px^2; xl, xr
    (..., 3, N)."""
    Fx = F @ xl
    Ftx = F.mT @ xr
    num = torch.sum(xr * Fx, dim=-2) ** 2
    den = Fx[..., 0, :] ** 2 + Fx[..., 1, :] ** 2 + Ftx[..., 0, :] ** 2 + Ftx[..., 1, :] ** 2
    return num / torch.clamp_min(den, 1e-12)


def ransac_fundamental(
    matches_left: torch.Tensor,     # (3, N)
    matches_right: torch.Tensor,
    samples: torch.Tensor,          # (num_hypotheses, 8) indices below num_matches_valid
    threshold: float = 1.0,         # cv::findFundamentalMat's default, px
    num_matches_valid: Optional[int] = None,
) -> FundamentalResult:
    """F by RANSAC over the hypotheses ``samples`` (the valid matches come
    first: columns past ``num_matches_valid`` are padding)."""
    n = matches_left.shape[-1]
    n_valid = n if num_matches_valid is None else num_matches_valid
    device = matches_left.device
    samples = samples.to(device)
    Fs = eight_point_fundamental(matches_left[:, samples].movedim(1, 0),
                                 matches_right[:, samples].movedim(1, 0))   # (K, 3, 3)
    d = sampson_distance(Fs, matches_left, matches_right)                # (K, N)
    in_range = torch.arange(n, device=device) < n_valid
    thr = threshold ** 2
    inliers = torch.sum((d < thr) & in_range, dim=-1)
    best = torch.argmax(inliers)

    # refit on the winner's 32 tightest matches (all inliers whenever the
    # model has 32); kept only if it loses no inlier
    order = torch.argsort(torch.where(in_range, d[best], torch.inf), stable=True)
    top = order[:min(32, n)]
    F_refit = eight_point_fundamental(matches_left[:, top], matches_right[:, top])
    d_refit = sampson_distance(F_refit, matches_left, matches_right)
    use_refit = torch.sum((d_refit < thr) & in_range) >= inliers[best]
    F = torch.where(use_refit, F_refit, Fs[best])
    mask = (torch.where(use_refit, d_refit, d[best]) < thr) & in_range
    return FundamentalResult(F=F, inlier_mask=mask, num_inliers=torch.sum(mask),
                             valid=inliers[best] >= 8)
