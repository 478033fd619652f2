"""Disparity post-processing, plain PyTorch.

Port of ``stereo_reconstruction_tpu/recon/disparity.py`` (reference
``removeDisparityOutliers`` / ``scaleDisparityMap`` /
``convertDisparityToDepth``,
``src/Reconstruction/reconstruction.cpp:5-43``). Invalid depth is -inf
(the reference's MINF).

The box blur sums separably with float64 prefix sums. At the default
500 x 500 kernel the window sums of a disparity map pass 2^24, where
float32 results depend on summation order; the JAX package sums in
float32, so blurred values agree to about 1e-6 relative, not bit for bit.
"""

from __future__ import annotations

import torch


def _reflect101_index(n: int, before: int, after: int, device) -> torch.Tensor:
    """Source index of every padded position, BORDER_REFLECT_101, for pads
    of any size (a 500-px kernel on a small image reflects many times)."""
    idx = torch.arange(-before, n + after, device=device)
    period = max(2 * n - 2, 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def _window_sum(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Sums of ``k`` consecutive entries along ``dim`` (VALID windows)."""
    c = torch.cumsum(x, dim=dim)
    zero = torch.zeros_like(c.narrow(dim, 0, 1))
    c = torch.cat([zero, c], dim=dim)
    n = c.shape[dim] - k
    return c.narrow(dim, k, n) - c.narrow(dim, 0, n)


def box_blur(img: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """cv::blur equivalent: normalized box filter, BORDER_REFLECT_101."""
    ka = (kernel_size - 1) // 2
    kb = kernel_size - 1 - ka
    h, w = img.shape
    x = img.to(torch.float64)
    x = x[_reflect101_index(h, ka, kb, img.device)]
    x = x[:, _reflect101_index(w, ka, kb, img.device)]
    s = _window_sum(_window_sum(x, kernel_size, 0), kernel_size, 1)
    return (s / (kernel_size * kernel_size)).to(torch.float32)


def remove_disparity_outliers(
    disparity: torch.Tensor,
    kernel_size: int = 500,
    thr_front: float = 1.5,
    thr_back: float = 0.8,
) -> torch.Tensor:
    """Clamp pixels outside [thr_back*blur, thr_front*blur] to the blurred
    value (reconstruction.cpp:5-18)."""
    disparity = disparity.to(torch.float32)
    blurred = box_blur(disparity, kernel_size)
    outlier = (disparity > thr_front * blurred) | (disparity < thr_back * blurred)
    return torch.where(outlier, blurred, disparity)


def scale_disparity(disparity: torch.Tensor, factor) -> torch.Tensor:
    """The disparity in float32 times ``factor`` (reconstruction.cpp:21-27)."""
    return disparity.to(torch.float32) * factor


def disparity_to_depth(
    disparity: torch.Tensor, focal_length, baseline: float = 1.0
) -> torch.Tensor:
    """depth = f*b/d in float32; zero disparity -> -inf
    (reconstruction.cpp:30-43). ``focal_length`` is a number or a tensor
    that broadcasts against ``disparity`` (one focal per pair of a batch)."""
    disparity = disparity.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=disparity.device)
    fb = torch.as_tensor(focal_length, **f32) * torch.as_tensor(baseline, **f32)
    zero = disparity == 0
    depth = fb / torch.where(zero, torch.ones_like(disparity), disparity)
    return torch.where(zero, torch.tensor(float("-inf"), **f32), depth)
