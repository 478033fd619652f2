"""Epipolar-line visualization (host-side).

Host NumPy copy of ``stereo_reconstruction_tpu/rectify/epilines.py``
(the port imports nothing of the JAX package). Equivalent of the
reference's ``computeEpiLines`` / ``drawEpilines`` /
``drawRectifiedEpilines`` (``src/Rectification/rectification.cpp:90-114,
558-635``): compute epilines from F for matched points and rasterize
colored lines + filled circles onto copies of the images. Pure NumPy —
visualization only, never on the metric path.

Deviations from the reference (intended semantics, per SURVEY §7):
  * the reference draws the epilines *of the left points* on the left
    image (rectification.cpp:605-612) — geometrically those lines live in
    the right image. Here each image gets the epilines induced by the
    OTHER image's points (l_left = F^T x_right, l_right = F x_left),
    which is the textbook visualization; on rectified pairs both
    renderings coincide (horizontal lines).
  * colors come from a seeded generator, not ``clock()``
    (rectification.cpp:591-592) — framework-wide determinism (SURVEY §5).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def epipolar_lines(F: np.ndarray, points: np.ndarray, which: int) -> np.ndarray:
    """Epilines for ``points`` ((N, 2) or (3, N)) of image ``which``
    (1=left, 2=right), normalized so a^2 + b^2 = 1 — the semantics of
    ``cv::computeCorrespondEpilines``. Returns (N, 3) line coefficients
    (a, b, c) valid in the OTHER image."""
    F = np.asarray(F, np.float64)
    pts = np.asarray(points, np.float64)
    if pts.ndim == 2 and pts.shape[-1] == 2:     # (N, 2) xy rows
        hom = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    elif pts.ndim == 2 and pts.shape[0] == 3:    # (3, N) homogeneous columns
        hom = pts.T
    else:
        hom = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    lines = hom @ (F.T if which == 1 else F)     # F x (img1) / F^T x' (img2)
    norm = np.linalg.norm(lines[:, :2], axis=1, keepdims=True)
    return lines / np.where(norm > 1e-12, norm, 1.0)


def epipole(F: np.ndarray) -> np.ndarray:
    """Right null vector of F (cv::SVD::solveZ, rectification.cpp:106-111)."""
    _, _, vt = np.linalg.svd(np.asarray(F, np.float64))
    return vt[-1]


def draw_epilines(
    image_left: np.ndarray,
    image_right: np.ndarray,
    F: np.ndarray,
    points_left: np.ndarray,
    points_right: np.ndarray,
    num_lines: int = 10,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render ``num_lines`` evenly-strided matches as epilines + filled
    circles (radius 4, rectification.cpp:593-632). Returns annotated
    uint8 RGB copies of both images."""
    left = _as_rgb(image_left)
    right = _as_rgb(image_right)
    pl = _as_xy(points_left)
    pr = _as_xy(points_right)
    n = len(pl)
    if n == 0:
        return left, right

    lines_r = epipolar_lines(F, pl, which=1)     # drawn on the right image
    lines_l = epipolar_lines(F, pr, which=2)     # drawn on the left image

    rng = np.random.default_rng(seed)
    stride = max(1, n // max(1, num_lines))      # i % (size/num_lines) == 0
    for i in range(0, n, stride):
        color = rng.integers(0, 255, 3).astype(np.uint8)
        _draw_line(left, lines_l[i], color)
        _draw_circle(left, pl[i], 4, color)
        _draw_line(right, lines_r[i], color)
        _draw_circle(right, pr[i], 4, color)
    return left, right


def draw_rectified_epilines(
    rectified_left: np.ndarray,
    rectified_right: np.ndarray,
    F_rectified: np.ndarray,
    matches_left: np.ndarray,
    matches_right: np.ndarray,
    num_lines: int = 10,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference drawRectifiedEpilines (rectification.cpp:558-581): the
    same rendering applied to the rectified pair with the re-estimated F
    (epilines come out horizontal when rectification succeeded)."""
    return draw_epilines(
        rectified_left, rectified_right, F_rectified,
        matches_left, matches_right, num_lines=num_lines, seed=seed,
    )


def _as_rgb(img: np.ndarray) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = np.clip(np.round(a), 0, 255).astype(np.uint8)
    if a.ndim == 2:
        a = np.stack([a] * 3, axis=-1)
    return a.copy()


def _as_xy(pts: np.ndarray) -> np.ndarray:
    p = np.asarray(pts, np.float64)
    if p.ndim == 2 and p.shape[-1] == 2:         # (N, 2) xy rows
        return p
    if p.ndim == 2 and p.shape[0] == 3:          # (3, N) homogeneous columns
        return (p[:2] / np.where(np.abs(p[2:3]) > 1e-12, p[2:3], 1.0)).T
    return p.reshape(-1, 2)


def _draw_line(img: np.ndarray, line: np.ndarray, color: np.ndarray) -> None:
    """Rasterize ax + by + c = 0 across the image (1 px, vectorized)."""
    h, w = img.shape[:2]
    a, b, c = line
    if abs(b) >= abs(a):                          # closer to horizontal
        xs = np.arange(w)
        ys = np.round(-(c + a * xs) / b).astype(np.int64)
        ok = (ys >= 0) & (ys < h)
        img[ys[ok], xs[ok]] = color
    else:
        ys = np.arange(h)
        xs = np.round(-(c + b * ys) / a).astype(np.int64)
        ok = (xs >= 0) & (xs < w)
        img[ys[ok], xs[ok]] = color


def _draw_circle(img: np.ndarray, center, radius: int, color) -> None:
    """Filled circle (cv::circle(..., FILLED))."""
    h, w = img.shape[:2]
    cx, cy = float(center[0]), float(center[1])
    y0, y1 = max(0, int(cy) - radius), min(h, int(cy) + radius + 1)
    x0, x1 = max(0, int(cx) - radius), min(w, int(cx) + radius + 1)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    mask = (yy - cy) ** 2 + (xx - cx) ** 2 <= radius * radius
    img[y0:y1, x0:x1][mask] = color
