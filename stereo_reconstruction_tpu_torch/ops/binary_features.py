"""ORB- and BRISK-style binary features: detection and description.

Port of ``stereo_reconstruction_tpu/ops/binary_features.py``, the frontend
of the reference's uncalibrated path (``src/rectification_main.cpp:26-63``:
cv::ORB with 500 features, scale factor 1.2, 4 levels, FAST threshold 20,
Harris ranking, patch 21; or cv::BRISK(30, 3, 1.0)). Every stage is a
dense array program over all pixels of a level:

  * the pyramid levels: bilinear resizes with antialiasing when they
    shrink (``jax.image.resize(..., "linear")``'s filter);
  * FAST-16: the 16 circle samples as 16 rolled copies, the "arc
    contiguous" test as windowed sums over the doubled stack; BRISK's
    saliency is the largest threshold at which the test still fires;
  * ORB ranks by the Harris response (Sobel-free central differences,
    Gaussian structure tensor), BRISK by saliency; 3x3 non-max
    suppression; per-level and then global top K, ties to the lower index;
  * ORB: intensity-centroid orientation and a rotated-BRIEF descriptor
    from a fixed seeded pattern; BRISK: the 60-point ring pattern on a
    per-ring blur stack, long pairs for the orientation, short pairs for
    the bits.

Descriptors are (K, bits) {0,1} float32 matrices, so Hamming matching is
one Gram matmul (``ops/matching.py::match_descriptors_binary``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from stereo_reconstruction_tpu_torch.config import BriskConfig, OrbConfig
from stereo_reconstruction_tpu_torch.ops.features import (
    Keypoints,
    _top_k,
    gaussian_blur,
    rgb_to_gray,
)

# FAST-16: the (dy, dx) offsets of the radius-3 Bresenham circle in
# circular order (OpenCV's ordering starts at (0, 3) going clockwise)
_FAST_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _resize(gray: torch.Tensor, shape) -> torch.Tensor:
    """Bilinear resize of an (H, W) plane, antialiased when it shrinks
    (the triangle filter widened by the scale, as ``jax.image.resize``'s
    "linear")."""
    return F.interpolate(gray[None, None], size=tuple(shape), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


def _bilinear(img: torch.Tensor, sy: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of one (H, W) plane at (sy, sx): taps at
    clip(floor, 0, n-2) with the unclipped fraction."""
    return _bilinear_planes(img[None], torch.zeros((), dtype=torch.long,
                                                   device=img.device), sy, sx)


def _bilinear_planes(stack: torch.Tensor, plane: torch.Tensor, sy: torch.Tensor,
                     sx: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of the (P, H, W) ``stack`` where sample i reads
    plane ``plane[i]`` (broadcast against sy, sx)."""
    _, h, w = stack.shape
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0f, sy - y0f
    x0 = x0f.to(torch.int64).clamp(0, w - 2)
    y0 = y0f.to(torch.int64).clamp(0, h - 2)
    v00, v01 = stack[plane, y0, x0], stack[plane, y0, x0 + 1]
    v10, v11 = stack[plane, y0 + 1, x0], stack[plane, y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _brief_pattern(num_bits: int, patch_size: int) -> np.ndarray:
    """The fixed BRIEF sampling pattern: ``num_bits`` point pairs ~ N(0,
    (patch/5)^2), clipped inside the patch, from a seeded generator (the
    JAX package's seed), (bits, pair, yx) float32."""
    rng = np.random.default_rng(0x0B1EF)
    sigma = patch_size / 5.0
    lim = patch_size / 2.0 - 1.0
    pts = rng.normal(0.0, sigma, size=(num_bits, 2, 2))
    return np.clip(pts, -lim, lim).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _brisk_pattern(pattern_scale: float, max_bits: int):
    """The BRISK sampling pattern (Leutenegger et al. 2011, Fig. 4, as
    cv::BRISK parameterises it): 60 points on rings of radii
    0.85 * pattern_scale * {0, 2.9, 4.9, 7.4, 10.8} with {1, 10, 14, 15, 20}
    points, a Gaussian sigma per ring from its point spacing; short pairs
    (dist < 5.85 * pattern_scale) are the bits, long pairs (dist > 8.2 *
    pattern_scale) vote the orientation.

    Returns numpy constants: pts (60, 2) [y, x], ring (60,), ring_sigmas
    (5,), short (S, 2) and long (L, 2) index pairs, and long_dir (L, 2)
    [y, x] = (p_j - p_i) / |p_j - p_i|^2."""
    f = 0.85 * pattern_scale
    radii = np.array([0.0, 2.9, 4.9, 7.4, 10.8], np.float64) * f
    counts = [1, 10, 14, 15, 20]
    pts, ring, ring_sigmas = [], [], []
    for ri, (r, n) in enumerate(zip(radii, counts)):
        ring_sigmas.append(0.5 if r == 0.0 else max(0.5, r * np.sin(np.pi / n)))
        for k in range(n):
            th = 2.0 * np.pi * k / n + (np.pi / n if ri % 2 else 0.0)
            pts.append((r * np.sin(th), r * np.cos(th)))
            ring.append(ri)
    pts = np.asarray(pts, np.float32)
    ring = np.asarray(ring, np.int32)

    ii, jj = np.triu_indices(len(pts), 1)
    d = pts[jj] - pts[ii]
    dist = np.linalg.norm(d, axis=1)
    short_sel = np.flatnonzero(dist < 5.85 * pattern_scale)
    short_sel = short_sel[np.argsort(dist[short_sel], kind="stable")][:max_bits]
    long_sel = np.flatnonzero(dist > 8.2 * pattern_scale)
    short = np.stack([ii[short_sel], jj[short_sel]], 1).astype(np.int32)
    long_ = np.stack([ii[long_sel], jj[long_sel]], 1).astype(np.int32)
    long_dir = (d[long_sel] / (dist[long_sel, None] ** 2)).astype(np.float32)
    return pts, ring, np.asarray(ring_sigmas, np.float32), short, long_, long_dir


def _circle(img: torch.Tensor) -> torch.Tensor:
    """The 16 FAST circle samples of every pixel, (16, H, W), wrapping at
    the borders."""
    return torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1))
                        for dy, dx in _FAST_OFFSETS])


def _arc_test(bits: torch.Tensor, arc: int) -> torch.Tensor:
    """True where >= ``arc`` circularly contiguous samples of the (16, H, W)
    stack are set: windowed sums over the doubled stack."""
    b = torch.cat([bits, bits[:arc - 1]]).to(torch.float32)
    csum = torch.cat([torch.zeros_like(b[:1]), torch.cumsum(b, dim=0)])
    return torch.amax(csum[arc:] - csum[:-arc], dim=0) >= arc


def _fast_score(diff: torch.Tensor, arc: int) -> torch.Tensor:
    """FAST saliency: the largest threshold at which the segment test still
    fires, the max over the 16 circular arcs of the arc's min of s - p
    (brighter) or p - s (darker); ``diff`` is (16, H, W)."""
    n = diff.shape[0]
    scores = []
    for sign in (1.0, -1.0):
        b = torch.cat([sign * diff, sign * diff[:arc - 1]])
        scores.append(torch.amax(b.unfold(0, arc, 1)[:n].amin(dim=-1), dim=0))
    return torch.maximum(scores[0], scores[1])


def _nms_top_k(resp: torch.Tensor, K: int):
    """3x3 non-max suppression of an (H, W) response (-inf = none), then its
    top K: (flat responses, y, x)."""
    lw = resp.shape[1]
    local_max = F.max_pool2d(resp[None, None], 3, stride=1, padding=1)[0, 0]
    resp = torch.where((resp == local_max) & torch.isfinite(resp), resp, -math.inf)
    vals, top = _top_k(resp.reshape(-1), K)
    return vals, top // lw, top % lw


def _interior(lh: int, lw: int, m: int, device) -> torch.Tensor:
    ys = torch.arange(lh, device=device)[:, None]
    xs = torch.arange(lw, device=device)[None, :]
    return (ys >= m) & (ys < lh - m) & (xs >= m) & (xs < lw - m)


def _merge_levels(per_level, K: int) -> Keypoints:
    """Concatenate the levels' (xy, resp, ori, desc, valid, scale) and keep
    the global top K by response, ties to the lower index."""
    xy, resp, ori, desc, valid, scl = (torch.cat([c[i] for c in per_level])
                                       for i in range(6))
    _, top = _top_k(torch.where(valid, resp, -math.inf), K)
    return Keypoints(xy=xy[top], scale=scl[top], response=resp[top],
                     orientation=ori[top], descriptors=desc[top], valid=valid[top])


def _too_small(name: str, h: int, w: int, edge_margin: int) -> ValueError:
    return ValueError(f"image {h}x{w} is smaller than one {name} level needs "
                      f"(2*edge_margin+8 = {2 * edge_margin + 8} px per side)")


def detect_and_describe_orb(image: torch.Tensor,
                            config: OrbConfig = OrbConfig()) -> Keypoints:
    """ORB keypoints of one (H, W, 3) or (H, W) 0..255 image: K =
    ``config.max_keypoints`` rows, 256-bit descriptors."""
    gray = rgb_to_gray(image)             # 0..255: the FAST threshold is 20 DN
    h, w = gray.shape
    K = config.max_keypoints
    per_level = []
    for level in range(config.num_levels):
        scale = config.scale_factor ** level
        lh, lw = int(round(h / scale)), int(round(w / scale))
        if lh < 2 * config.edge_margin + 8 or lw < 2 * config.edge_margin + 8:
            break
        img = gray if level == 0 else _resize(gray, (lh, lw))
        per_level.append(_level_keypoints(img, float(scale), config, K))
    if not per_level:
        raise _too_small("ORB", h, w, config.edge_margin)
    return _merge_levels(per_level, K)


def _level_keypoints(img: torch.Tensor, scale: float, config: OrbConfig, K: int):
    lh, lw = img.shape
    t = float(config.fast_threshold)
    shifted = _circle(img)
    is_corner = (_arc_test(shifted > img[None] + t, config.fast_arc)
                 | _arc_test(shifted < img[None] - t, config.fast_arc))

    # Harris response for ranking (ORB::HARRIS_SCORE)
    gx = (torch.roll(img, -1, 1) - torch.roll(img, 1, 1)) / 2.0
    gy = (torch.roll(img, -1, 0) - torch.roll(img, 1, 0)) / 2.0
    sxx = gaussian_blur(gx * gx, 1.5)
    syy = gaussian_blur(gy * gy, 1.5)
    sxy = gaussian_blur(gx * gy, 1.5)
    harris = (sxx * syy - sxy * sxy) - config.harris_k * (sxx + syy) ** 2

    resp = torch.where(is_corner & _interior(lh, lw, config.edge_margin, img.device),
                       harris, -math.inf)
    vals, yi, xi = _nms_top_k(resp, K)
    valid = torch.isfinite(vals) & (vals > 0)
    ori = _intensity_centroid(img, yi, xi, config.patch_size)
    pattern = torch.from_numpy(_brief_pattern(config.num_bits, config.patch_size)).to(
        img.device)
    desc = _rbrief(gaussian_blur(img, 2.0), yi, xi, ori, pattern)
    xy = torch.stack([xi.to(torch.float32) * scale, yi.to(torch.float32) * scale], dim=-1)
    scl = torch.full((len(vals),), scale, dtype=torch.float32, device=img.device)
    return xy, vals, ori, desc, valid, scl


def _intensity_centroid(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor,
                        patch_size: int) -> torch.Tensor:
    """ORB orientation: theta = atan2(m01, m10) over a circular patch of
    radius patch_size // 2, centred at the keypoint clipped inside."""
    r = patch_size // 2
    lh, lw = img.shape
    ys = yi.clamp(r, lh - r - 1)
    xs = xi.clamp(r, lw - r - 1)
    offs = torch.arange(-r, r + 1, device=img.device)
    p = img[(ys[:, None] + offs)[:, :, None], (xs[:, None] + offs)[:, None, :]]
    dy = offs.to(torch.float32)[:, None]
    dx = offs.to(torch.float32)[None, :]
    p = torch.where((dy * dy + dx * dx) <= r * r, p, 0.0)
    return torch.atan2(torch.sum(p * dy, dim=(1, 2)), torch.sum(p * dx, dim=(1, 2)))


def _rbrief(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor, ori: torch.Tensor,
            pattern: torch.Tensor) -> torch.Tensor:
    """Rotated BRIEF: bit = I(R(theta) p1) < I(R(theta) p2), bilinear;
    (K, bits)."""
    lh, lw = img.shape
    ct = torch.cos(ori)[:, None, None]
    st = torch.sin(ori)[:, None, None]
    py, px = pattern[..., 0], pattern[..., 1]            # (bits, 2)
    ry = st * px + ct * py
    rx = ct * px - st * py                               # (K, bits, 2)
    sy = (yi.to(torch.float32)[:, None, None] + ry).clamp(0.0, lh - 2.0)
    sx = (xi.to(torch.float32)[:, None, None] + rx).clamp(0.0, lw - 2.0)
    v = _bilinear(img, sy, sx)
    return (v[..., 0] < v[..., 1]).to(torch.float32)


def detect_and_describe_brisk(image: torch.Tensor,
                              config: BriskConfig = BriskConfig()) -> Keypoints:
    """BRISK keypoints of one (H, W, 3) or (H, W) 0..255 image over the
    octave ladder (scales 2^i and 1.5 * 2^i), up to 512-bit descriptors."""
    gray = rgb_to_gray(image)
    h, w = gray.shape
    K = config.max_keypoints
    pattern = _brisk_pattern(float(config.pattern_scale), int(config.max_bits))
    scales = []
    for i in range(config.octaves):
        scales += [2.0 ** i, 1.5 * 2.0 ** i]
    per_level = []
    for scale in scales:
        lh, lw = int(round(h / scale)), int(round(w / scale))
        if lh < 2 * config.edge_margin + 8 or lw < 2 * config.edge_margin + 8:
            break
        img = gray if scale == 1.0 else _resize(gray, (lh, lw))
        per_level.append(_brisk_level(img, float(scale), config, K, pattern))
    if not per_level:
        raise _too_small("BRISK", h, w, config.edge_margin)
    return _merge_levels(per_level, K)


def _brisk_level(img: torch.Tensor, scale: float, config: BriskConfig, K: int, pattern):
    pts, ring, ring_sigmas, short, long_, long_dir = pattern
    lh, lw = img.shape
    device = img.device
    saliency = _fast_score(_circle(img) - img[None], config.fast_arc)
    resp = torch.where(_interior(lh, lw, config.edge_margin, device)
                       & (saliency > config.threshold), saliency, -math.inf)
    vals, yi, xi = _nms_top_k(resp, K)
    valid = torch.isfinite(vals)

    # the per-ring blur stack the descriptor samples
    blurs = torch.stack([gaussian_blur(img, float(s)) for s in ring_sigmas])

    def const(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    plane = const(ring, torch.int64)
    py, px = const(pts[:, 0]), const(pts[:, 1])          # (60,)
    li, lj = const(long_[:, 0], torch.int64), const(long_[:, 1], torch.int64)
    si, sj = const(short[:, 0], torch.int64), const(short[:, 1], torch.int64)
    gdir = const(long_dir)                                # (L, 2) [y, x] / d^2
    yf = yi.to(torch.float32)[:, None]
    xf = xi.to(torch.float32)[:, None]

    def sample(ry, rx):
        return _bilinear_planes(blurs, plane, (yf + ry).clamp(0.0, lh - 2.0),
                                (xf + rx).clamp(0.0, lw - 2.0))

    v0 = sample(py, px)                                   # (K, 60)
    # orientation: the mean over long pairs of (I_j - I_i) (p_j - p_i) / d^2
    dv = v0[:, lj] - v0[:, li]                            # (K, L)
    g = torch.mean(dv[:, :, None] * gdir, dim=1)          # (K, 2) [gy, gx]
    theta = torch.atan2(g[:, 0], g[:, 1])
    ct, st = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    v1 = sample(st * px + ct * py, ct * px - st * py)     # the rotated pattern
    desc = (v1[:, sj] > v1[:, si]).to(torch.float32)
    xy = torch.stack([xi.to(torch.float32) * scale, yi.to(torch.float32) * scale], dim=-1)
    scl = torch.full((len(vals),), scale, dtype=torch.float32, device=device)
    return xy, vals, theta, desc, valid, scl
