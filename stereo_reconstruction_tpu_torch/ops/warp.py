"""Perspective warps (``cv::warpPerspective`` semantics).

Port of ``stereo_reconstruction_tpu/ops/warp.py`` (``warp_perspective``,
``warp_inverse_map``, ``transform_points``): inverse mapping — every
destination pixel is projected through H^{-1} into the source and sampled
bilinearly (or nearest, round half to even), zero outside the source
(reference rectification.cpp:486-493 and :71-87). The JAX package's
gather-free band warp exists only because TPU gathers are slow; here the
general gather warp serves every homography.

``warp_perspective`` takes one image or a batch, inverts H in float32 on
the host (``host_inverse``) and hands the maps to ``warp_inverse_maps``,
the one place a warp picks its route: the plain PyTorch twin
``warp_inverse_map`` below for CPU images, one launch of the warp kernel
(``ops/cuda_warp.py``, bit-equal to the twin) for CUDA ones. A CUDA image
launches or raises; nothing falls back.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from stereo_reconstruction_tpu_torch.ops import cuda_warp


def host_inverse(H) -> torch.Tensor:
    """``torch.linalg.inv`` of H, (3, 3) or (B, 3, 3), in float32 on the
    CPU: NumPy as it is, a tensor copied to the host first. A singular H
    raises ``torch.linalg.LinAlgError``."""
    H = H.detach().cpu() if isinstance(H, torch.Tensor) else torch.as_tensor(np.asarray(H))
    return torch.linalg.inv(H.to(torch.float32))


def warp_perspective(
    image: Union[torch.Tensor, Sequence[torch.Tensor]],
    H,                            # (3, 3) or (B, 3, 3): SOURCE coords -> DEST coords
    out_shape: Tuple[int, int],
    method: str = "bilinear",
) -> torch.Tensor:
    """dst(p) = src(H^{-1} p) in an ``out_shape`` canvas, float32, with
    H^{-1} computed on the host. One image (h, w) or (h, w, C) with H
    (3, 3); or a batch with H (B, 3, 3): B images, a sequence (each its own
    h, w) or a (B, h, w[, C]) tensor, giving (B, h_out, w_out[, C])."""
    Hinv = host_inverse(H)
    if Hinv.ndim == 2:
        return warp_inverse_maps([image], Hinv[None], out_shape, method)[0]
    return warp_inverse_maps(image, Hinv, out_shape, method)


def warp_inverse_maps(
    images: Sequence[torch.Tensor],
    Hinv: torch.Tensor,           # (B, 3, 3) DEST -> SOURCE; on the CPU for CUDA images
    out_shape: Tuple[int, int],
    method: str = "bilinear",
) -> torch.Tensor:
    """``warp_inverse_map`` of each image with its map, stacked: the twin
    for CPU images, ``cuda_warp.warp`` (one launch) for CUDA images."""
    images = list(images)
    if not images or tuple(Hinv.shape) != (len(images), 3, 3):
        raise ValueError(f"expected B images and (B, 3, 3) maps, got {len(images)} images "
                         f"and {tuple(Hinv.shape)}")
    if any(img.shape[2:] != images[0].shape[2:] for img in images):
        raise ValueError("a batch's images must share their channels, got "
                         f"{[tuple(img.shape) for img in images]}")
    if all(img.device.type == "cpu" for img in images):
        return torch.stack([warp_inverse_map(img, m, out_shape, method)
                            for img, m in zip(images, Hinv)])
    return cuda_warp.warp(images, Hinv, out_shape, method)


def _int_coord(v: torch.Tensor, n: int) -> torch.Tensor:
    """float -> int32 with out-of-range values pinned just outside [0, n),
    so the conversion is defined and they stay outside."""
    return v.clamp(-2.0, n + 1.0).to(torch.int32)


def warp_inverse_map(
    image: torch.Tensor,
    Hinv: torch.Tensor,           # (3, 3) maps DEST coords -> SOURCE coords
    out_shape: Tuple[int, int],
    method: str = "bilinear",
) -> torch.Tensor:
    h_out, w_out = out_shape
    h, w = image.shape[:2]
    squeeze = image.ndim == 2
    img = (image[..., None] if squeeze else image).to(torch.float32)
    device = img.device
    Hinv = Hinv.to(device=device, dtype=torch.float32)

    ys = torch.arange(h_out, dtype=torch.float32, device=device)
    xs = torch.arange(w_out, dtype=torch.float32, device=device)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")          # (h_out, w_out)
    denom = Hinv[2, 0] * gx + Hinv[2, 1] * gy + Hinv[2, 2]
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    sx = (Hinv[0, 0] * gx + Hinv[0, 1] * gy + Hinv[0, 2]) / denom
    sy = (Hinv[1, 0] * gx + Hinv[1, 1] * gy + Hinv[1, 2]) / denom

    if method == "nearest":
        ix = _int_coord(torch.round(sx), w)
        iy = _int_coord(torch.round(sy), h)
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        v = img[iy.clamp(0, h - 1).long(), ix.clamp(0, w - 1).long()]
        out = v * inside[..., None]
    elif method == "bilinear":
        x0 = torch.floor(sx)
        y0 = torch.floor(sy)
        fx = (sx - x0)[..., None]
        fy = (sy - y0)[..., None]
        x0i = _int_coord(x0, w)
        y0i = _int_coord(y0, h)

        def gather(yy, xx):
            inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            v = img[yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()]
            return v * inside[..., None]

        v00 = gather(y0i, x0i)
        v01 = gather(y0i, x0i + 1)
        v10 = gather(y0i + 1, x0i)
        v11 = gather(y0i + 1, x0i + 1)
        out = (
            v00 * (1 - fx) * (1 - fy)
            + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy
            + v11 * fx * fy
        )
    else:
        raise ValueError(f"unknown warp method {method!r}")

    return out[..., 0] if squeeze else out


def transform_points(H: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """cv::perspectiveTransform equivalent: (..., 2, N) points through H."""
    if points.shape[-2] == 2:
        points = torch.cat([points, torch.ones_like(points[..., :1, :])], dim=-2)
    mapped = H @ points
    return mapped[..., :2, :] / mapped[..., 2:3, :]
