"""Parallel-hypothesis RANSAC for the eight-point solve.

Port of ``stereo_reconstruction_tpu/pose/ransac.py`` (the reference's
sequential point-swap RANSAC, ``eight_point.cpp:253-361``, as K
independent hypotheses solved in one batch): cheirality-invalid
hypotheses are discarded, the winner has the most Sampson inliers over
the full match set (ties to the lower mean sample error, then the lower
index), and ``refine_rounds`` refits on the tightest ``refine_support``
matches are kept when they lose no inliers.

The draws are an input. JAX draws each hypothesis's uniforms from a
threefry key, which torch cannot reproduce, so ``ransac_eight_point``
takes the (num_hypotheses, n) uniform matrix ``u`` itself and forms the
samples as the JAX ``draw`` does. Without ``uniforms`` it draws ``u`` on
the CPU from ``generator`` (``draw_uniforms``) and copies it to the
matches' device, so a CPU run and a CUDA run with the same seed try the
same hypotheses.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stereo_reconstruction_tpu_torch.config import RansacConfig
from stereo_reconstruction_tpu_torch.ops import geometry as geo
from stereo_reconstruction_tpu_torch.pose.eight_point import eight_point


class RansacResult(NamedTuple):
    rotation: torch.Tensor        # (3, 3)
    translation: torch.Tensor     # (3,)
    essential: torch.Tensor       # (3, 3)
    pose: torch.Tensor            # (4, 4)
    sample_indices: torch.Tensor  # (refine_support,) winning sample
    inlier_count: torch.Tensor    # () int
    mean_error: torch.Tensor      # () mean px error over the winning sample
    success: torch.Tensor         # () bool: all sample errors < threshold
    valid: torch.Tensor           # () bool: some hypothesis is cheirality-valid


def draw_uniforms(config: RansacConfig, n: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(num_hypotheses, n) uniforms in [0, 1), drawn on the CPU."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.rand((config.num_hypotheses, n), generator=generator,
                      dtype=torch.float32)


def _sampson_sq(F, xl, xr):
    """Squared Sampson distance per match, px^2."""
    Fx = F @ xl
    Ftx = F.mT @ xr
    num = torch.sum(xr * Fx, dim=-2) ** 2
    den = Fx[..., 0, :] ** 2 + Fx[..., 1, :] ** 2 + Ftx[..., 0, :] ** 2 + Ftx[..., 1, :] ** 2
    return num / torch.clamp_min(den, 1e-12)


def ransac_eight_point(
    matches_left: torch.Tensor,     # (3, N) homogeneous pixels
    matches_right: torch.Tensor,    # (3, N)
    K_left: torch.Tensor,
    K_right: torch.Tensor,
    config: RansacConfig = RansacConfig(),
    num_matches_valid=None,         # int or 0-d tensor (None -> all N)
    uniforms: Optional[torch.Tensor] = None,    # (num_hypotheses, N)
    generator: Optional[torch.Generator] = None,
) -> RansacResult:
    device = matches_left.device
    n = matches_left.shape[-1]
    n_valid = torch.as_tensor(n if num_matches_valid is None else num_matches_valid,
                              device=device)
    s = config.sample_size
    if uniforms is None:
        uniforms = draw_uniforms(config, n, generator)
    u = torch.as_tensor(uniforms, dtype=torch.float32).to(device)

    # num_hypotheses samples of s distinct indices in [0, n_valid): the
    # ranks of the uniforms restricted to the valid prefix
    in_range = torch.arange(n, device=device) < n_valid
    u = torch.where(in_range, u, torch.inf)
    samples = torch.argsort(u, dim=-1, stable=True)[:, :s]     # (K, s)

    sl = matches_left[:, samples].movedim(1, 0)                # (K, 3, s)
    sr = matches_right[:, samples].movedim(1, 0)
    results = eight_point(sl, sr, K_left, K_right)

    # score 1: per-sample projected pixel error (eight_point.cpp:282-287)
    sample_err = geo.pixel_error(geo.project(K_right, results.points_right), sr)
    mean_err = torch.mean(sample_err, dim=-1)
    all_below = torch.all(sample_err < config.error_threshold, dim=-1)

    # score 2: full-set inliers by Sampson distance on F
    def full_inliers(E):
        F = geo.fundamental_from_essential(E, K_left, K_right)
        d2 = _sampson_sq(F, matches_left, matches_right)
        return torch.sum((d2 < config.error_threshold ** 2) & in_range, dim=-1)

    inliers = torch.where(results.valid, full_inliers(results.essential), -1)
    score = inliers.to(torch.float32) - 1e-6 * mean_err
    best = torch.argmax(score)

    support = min(config.refine_support, n)
    init_sample = samples[best][: min(s, support)]
    if init_sample.shape[0] < support:
        init_sample = torch.nn.functional.pad(init_sample,
                                              (0, support - init_sample.shape[0]))
    cur = dict(
        rotation=results.rotation[best],
        translation=results.translation[best],
        essential=results.essential[best],
        pose=results.pose[best],
        sample=init_sample,
        inliers=inliers[best],
        mean_error=mean_err[best],
        success=all_below[best] & results.valid[best],
    )
    # local refinement (eight_point.cpp:294-359): re-solve on the current
    # model's tightest `support` matches; keep a refit that is
    # cheirality-valid and loses no inliers
    for _ in range(config.refine_rounds):
        F_cur = geo.fundamental_from_essential(cur["essential"], K_left, K_right)
        d2 = _sampson_sq(F_cur, matches_left, matches_right)
        top = torch.argsort(torch.where(in_range, d2, torch.inf), stable=True)[:support]
        ml, mr = matches_left[:, top], matches_right[:, top]
        refit = eight_point(ml, mr, K_left, K_right)
        refit_inl = torch.where(refit.valid, full_inliers(refit.essential), -1)
        use = refit_inl >= cur["inliers"]
        errs = geo.pixel_error(geo.project(K_right, refit.points_right), mr)
        new = dict(
            rotation=refit.rotation,
            translation=refit.translation,
            essential=refit.essential,
            pose=refit.pose,
            sample=top,
            inliers=refit_inl,
            mean_error=torch.mean(errs),
            success=torch.all(errs < config.error_threshold) & refit.valid,
        )
        cur = {k: torch.where(use, new[k], cur[k]) for k in cur}

    return RansacResult(
        rotation=cur["rotation"],
        translation=cur["translation"],
        essential=cur["essential"],
        pose=cur["pose"],
        sample_indices=cur["sample"],
        inlier_count=cur["inliers"],
        mean_error=cur["mean_error"],
        success=cur["success"],
        valid=torch.any(results.valid),
    )
