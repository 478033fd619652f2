"""Parallel-hypothesis RANSAC for the eight-point solve.

Port of ``stereo_reconstruction_tpu/pose/ransac.py`` (the reference's
sequential point-swap RANSAC, ``eight_point.cpp:253-361``, as K
independent hypotheses solved in one batch): cheirality-invalid
hypotheses are discarded, the winner has the most Sampson inliers over
the full match set (ties to the lower mean sample error, then the lower
index), and ``refine_rounds`` refits on the tightest ``refine_support``
matches are kept when they lose no inliers. It also returns the best
fitting of the hypotheses with the most inliers (``fit_pose``, by
``match_fit``), for ``pose.pipeline.refine_pose``'s second BA.

The draws are an input. JAX draws each hypothesis's uniforms from a
threefry key, which torch cannot reproduce, so ``ransac_eight_point``
takes the (num_hypotheses, n) uniform matrix ``u`` itself and forms the
samples as the JAX ``draw`` does. Without ``uniforms`` it draws ``u`` on
the CPU from ``generator`` (``draw_uniforms``) and copies it to the
matches' device, so a CPU run and a CUDA run with the same seed try the
same hypotheses.

On the card ``ransac_eight_point`` is the hand-written kernel
(``csrc/ransac.cuh``, launched by ``ops/cuda_ransac.py``): two launches in
place of the ~45,000 small ops of ``ransac_plain``, its plain twin, which
CPU matches take. Nothing falls back: a CUDA input the kernel does not take
raises, and ``check_kernel_config`` lets a caller raise before SIFT.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stereo_reconstruction_tpu_torch.config import RansacConfig
from stereo_reconstruction_tpu_torch.kernels.launch import on_card
from stereo_reconstruction_tpu_torch.ops import cuda_ransac, geometry as geo
from stereo_reconstruction_tpu_torch.pose.eight_point import EightPointResult, eight_point


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
    fit_pose: torch.Tensor        # (4, 4) of the most-inlier hypotheses, the best fitting
    fit_error: torch.Tensor       # () its ``match_fit``


def check_kernel_config(config: RansacConfig, n: int, device) -> None:
    """Raise ValueError where the card's kernel does not take ``config`` on
    N matches (``cuda_ransac.check_config``); nothing for the CPU. The posed
    paths call it before SIFT."""
    if torch.device(device).type == "cuda":
        cuda_ransac.check_config(config, n)


def draw_uniforms(config: RansacConfig, n: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(num_hypotheses, n) uniforms in [0, 1), drawn on the CPU."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return torch.rand((config.num_hypotheses, n), generator=generator,
                      dtype=torch.float32)


def match_fit(F, matches_left, matches_right, n_valid, threshold: float) -> torch.Tensor:
    """How well F fits the first ``n_valid`` matches: their squared Sampson
    distances, each capped at ``threshold`` squared (MSAC), averaged, px^2."""
    in_range = torch.arange(matches_left.shape[-1], device=matches_left.device) < n_valid
    d2 = torch.clamp_max(_sampson_sq(F, matches_left, matches_right), threshold ** 2)
    return (torch.sum(torch.where(in_range, d2, 0.0), dim=-1)
            / torch.clamp_min(n_valid, 1).to(torch.float32))


def _sampson_sq(F, xl, xr):
    """Squared Sampson distance per match, px^2."""
    Fx = F @ xl
    Ftx = F.mT @ xr
    num = torch.sum(xr * Fx, dim=-2) ** 2
    den = Fx[..., 0, :] ** 2 + Fx[..., 1, :] ** 2 + Ftx[..., 0, :] ** 2 + Ftx[..., 1, :] ** 2
    return num / torch.clamp_min(den, 1e-12)


class Hypotheses(NamedTuple):
    """The K hypotheses of ``ransac_eight_point`` before the winner."""
    samples: torch.Tensor         # (K, s) match indices
    results: EightPointResult     # each field with a leading K
    mean_error: torch.Tensor      # (K,) mean px error over the sample
    all_below: torch.Tensor       # (K,) bool: every sample error < threshold
    inliers: torch.Tensor         # (K,) Sampson inliers over the valid matches, -1 invalid
    fits: torch.Tensor            # (K,) ``match_fit`` of each hypothesis's F


def score_hypotheses(matches_left, matches_right, K_left, K_right, config: RansacConfig,
                     n_valid: torch.Tensor, u: torch.Tensor) -> Hypotheses:
    """The plain twin of the kernel's first launch: each hypothesis's sample,
    eight-point solve and scores."""
    n = matches_left.shape[-1]
    s = config.sample_size
    # num_hypotheses samples of s distinct indices in [0, n_valid): the
    # ranks of the uniforms restricted to the valid prefix
    in_range = torch.arange(n, device=matches_left.device) < n_valid
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
    inliers = torch.where(results.valid, _full_inliers(results.essential, matches_left,
                                                       matches_right, K_left, K_right,
                                                       in_range, config), -1)
    fits = match_fit(geo.fundamental_from_essential(results.essential, K_left, K_right),
                     matches_left, matches_right, n_valid, config.error_threshold)
    return Hypotheses(samples, results, mean_err, all_below, inliers, fits)


def _full_inliers(E, matches_left, matches_right, K_left, K_right, in_range,
                  config: RansacConfig):
    F = geo.fundamental_from_essential(E, K_left, K_right)
    d2 = _sampson_sq(F, matches_left, matches_right)
    return torch.sum((d2 < config.error_threshold ** 2) & in_range, dim=-1)


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
    """Matches and intrinsics on one CUDA device: the kernel
    (``ops/cuda_ransac.py``, two launches; a batch's under
    ``torch.func.vmap`` too); on the CPU: ``ransac_plain``."""
    card = on_card("ransac", matches_left, matches_right, K_left, K_right)
    device = matches_left.device
    n = matches_left.shape[-1]
    n_valid = torch.as_tensor(n if num_matches_valid is None else num_matches_valid,
                              device=device)
    if uniforms is None:
        uniforms = draw_uniforms(config, n, generator)
    u = torch.as_tensor(uniforms, dtype=torch.float32).to(device)
    if card:
        return RansacResult(*cuda_ransac.ransac_eight_point_op(
            matches_left, matches_right, K_left, K_right, n_valid.to(torch.int64), u,
            config.num_hypotheses, config.sample_size, float(config.error_threshold),
            config.refine_rounds, config.refine_support))
    return ransac_plain(matches_left, matches_right, K_left, K_right, config, n_valid, u)


def ransac_plain(matches_left, matches_right, K_left, K_right, config: RansacConfig,
                 n_valid: torch.Tensor, u: torch.Tensor) -> RansacResult:
    """The kernel's plain twin, on the matches' device: ``score_hypotheses``,
    the winner and the best fitting hypothesis, then the refits."""
    device = matches_left.device
    n = matches_left.shape[-1]
    s = config.sample_size
    in_range = torch.arange(n, device=device) < n_valid
    hyp = score_hypotheses(matches_left, matches_right, K_left, K_right, config, n_valid, u)
    samples, results, mean_err, inliers, fits = (hyp.samples, hyp.results, hyp.mean_error,
                                                 hyp.inliers, hyp.fits)
    score = inliers.to(torch.float32) - 1e-6 * mean_err
    best = torch.argmax(score).reshape(1)
    # the best fitting of the hypotheses with the most inliers, for
    # ``pose.pipeline.refine_pose``'s second BA (float32 rounds the -1e-6 *
    # mean_err away at a few hundred inliers, so ``best`` is the first of
    # them, however it fits)
    fit = torch.argmin(torch.where(inliers == torch.amax(inliers), fits, torch.inf)).reshape(1)

    def pick(x):
        # x[best] with a 0-d tensor index would read it on the host
        return torch.index_select(x, 0, best)[0]

    support = min(config.refine_support, n)
    init_sample = pick(samples)[: min(s, support)]
    if init_sample.shape[0] < support:
        init_sample = torch.nn.functional.pad(init_sample,
                                              (0, support - init_sample.shape[0]))
    cur = dict(
        rotation=pick(results.rotation),
        translation=pick(results.translation),
        essential=pick(results.essential),
        pose=pick(results.pose),
        sample=init_sample,
        inliers=pick(inliers),
        mean_error=pick(mean_err),
        success=pick(hyp.all_below) & pick(results.valid),
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
        refit_inl = torch.where(refit.valid, _full_inliers(refit.essential, matches_left,
                                                           matches_right, K_left, K_right,
                                                           in_range, config), -1)
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
        fit_pose=torch.index_select(results.pose, 0, fit)[0],
        fit_error=torch.index_select(fits, 0, fit)[0],
    )
