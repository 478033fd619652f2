"""Disparity evaluation metrics, plain PyTorch.

Port of ``stereo_reconstruction_tpu/ops/metrics.py`` (the reference's
Middlebury metric, ``src/utils.cpp:123-168``): GT +inf pixels are
unknown and skipped; a prediction is valid iff it is != 0; valid
predictions are clamped to [0, max_disp] (optionally rounded); only
mask == 255 pixels are evaluated; avg_err averages |d - gt| over valid
evaluated pixels. Values are 0-dim tensors.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def evaldisp(
    disp: torch.Tensor,        # (H, W) predicted disparity
    gt_disp: torch.Tensor,     # (H, W) GT, +inf = unknown
    mask: torch.Tensor,        # (H, W) uint8 nocc mask, 255 = evaluate
    bad_thresh: float = 2.0,
    max_disp: float = math.inf,
    round_disp: bool = False,
) -> Dict[str, torch.Tensor]:
    disp = disp.to(torch.float32)
    gt = gt_disp.to(device=disp.device, dtype=torch.float32)
    mask = mask.to(disp.device)

    evaluated = torch.isfinite(gt) & (mask == 255)
    valid = disp != 0
    # max_disp may be a 0-d tensor (one per pair under torch.func.vmap)
    d = torch.minimum(disp.clamp(min=0.0),
                      torch.as_tensor(max_disp, dtype=torch.float32, device=disp.device))
    if round_disp:
        d = torch.round(d)
    d = torch.where(valid, d, disp)
    err = (d - gt).abs()

    n = evaluated.sum()
    n_valid = (evaluated & valid).sum()
    invalid = n - n_valid
    bad = (evaluated & valid & (err > bad_thresh)).sum()
    serr = torch.where(evaluated & valid, err, torch.zeros_like(err)).sum()

    nf = n.to(torch.float32)
    return {
        "n_evaluated": n,
        "coverage_percent": 100.0 * nf / disp.numel(),
        "bad_percent": 100.0 * bad / nf,
        "invalid_percent": 100.0 * invalid / nf,
        "total_bad_percent": 100.0 * (bad + invalid) / nf,
        "avg_err": serr / n_valid.clamp(min=1).to(torch.float32),
    }


def bad_curve(
    disp: torch.Tensor,
    gt_disp: torch.Tensor,
    mask: torch.Tensor,
    thresholds=(0.5, 1.0, 2.0, 4.0),
    max_disp: float = math.inf,
) -> Dict[str, torch.Tensor]:
    """bad-t for the standard Middlebury threshold set."""
    out = {}
    for t in thresholds:
        m = evaldisp(disp, gt_disp, mask, bad_thresh=t, max_disp=max_disp)
        out[f"bad_{t}"] = m["bad_percent"]
    out["avg_err"] = m["avg_err"]
    out["invalid_percent"] = m["invalid_percent"]
    return out


def average_valid_disparity(disp: torch.Tensor) -> torch.Tensor:
    """Mean over non-inf entries (reference computeAverageDisparity,
    utils.cpp:8-20)."""
    finite = torch.isfinite(disp)
    total = torch.where(finite, disp, torch.zeros_like(disp)).sum()
    return total / finite.sum().clamp(min=1)


def endpoint_error(disp: torch.Tensor, gt_disp: torch.Tensor, mask: torch.Tensor):
    """RMS + mean endpoint error over evaluated pixels."""
    evaluated = torch.isfinite(gt_disp) & (mask == 255)
    err = torch.where(evaluated, disp - gt_disp, torch.zeros_like(disp))
    n = evaluated.sum().clamp(min=1).to(torch.float32)
    mean = err.abs().sum() / n
    rms = torch.sqrt((err * err).sum() / n)
    return {"epe": mean, "rms": rms}
