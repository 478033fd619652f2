"""DoG/SIFT-style feature detection and description, batched over images.

Port of ``stereo_reconstruction_tpu/ops/features.py`` (the reference's
OpenCV SIFT frontend, ``src/PoseEstimation/keypoints.cpp:27-32``):
Gaussian scale space and DoG planes per octave; 3x3x3 extrema with the
contrast and Hessian-ratio edge tests; per-octave and then global top-K
by |response| (ties to the lower index); a 36-bin orientation histogram
over a 17x17 patch; a 4x4x8 descriptor sampled on a rotated 16x16 grid,
L2-normalised with the 0.2 clip.

The TPU forms are replaced by their plain counterparts with the same
arithmetic: the banded-Toeplitz blur matmuls by a separable reflect-101
blur (each output a dot of the 2r+1 taps with its window), and the
row-band one-hot contractions of the orientation and descriptor stages
by direct indexing into the padded (n_oct * s, H0, W0) gradient stack,
with ``scatter_add_`` histograms. The sampling keeps the JAX package's
clip semantics: bilinear taps at x0 = clip(floor(sx), 0, w-2) with the
unclipped fraction, summed x first and then y; nearest taps clipped to
the plane; the orientation patch centred at clip(y, R, h-R-1).
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from stereo_reconstruction_tpu_torch.config import FrontendConfig
from stereo_reconstruction_tpu_torch.kernels.launch import on_card
from stereo_reconstruction_tpu_torch.ops import cuda_sift
from stereo_reconstruction_tpu_torch.ops.cost_volume import sqrt_rn

_R_ORI = 8      # orientation patch radius (17x17)
_GRID = 16      # descriptor sample grid (16x16 -> 4x4 cells x 8 bins)


class Keypoints(NamedTuple):
    xy: torch.Tensor           # (..., K, 2) pixel coords (x, y) in the image
    scale: torch.Tensor        # (..., K) sigma of the detection scale
    response: torch.Tensor     # (..., K) |DoG| response
    orientation: torch.Tensor  # (..., K) radians
    descriptors: torch.Tensor  # (..., K, 128) L2-normalised
    valid: torch.Tensor        # (..., K) bool


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """BT.601 luma (cv::cvtColor BGR2GRAY weights on RGB input), float32."""
    image = image.to(torch.float32)
    if image.ndim == 2:
        return image
    return 0.299 * image[..., 0] + 0.587 * image[..., 1] + 0.114 * image[..., 2]


@functools.lru_cache(maxsize=64)
def _taps(sigma: float) -> np.ndarray:
    """Discrete Gaussian taps: float64, normalised, cast to float32."""
    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (..., H, W) float32 with reflect-101
    borders: rows first, then columns.

    On the CPU each output is a matmul of its window with the taps. On the
    card it is the SIFT level kernel (``ops/cuda_sift.py``, one launch),
    which adds the 2r+1 products in tap order as ``blur_in_tap_order`` does:
    cuBLAS picks its matmul kernel by the problem's size, so there an
    image's blur, and its keypoints, moved with the number of images in the
    batch, enough to change a pair's RANSAC winner with its batch-mates. The CPU's matmul does not
    depend on the batch and keeps the rounding the tests against the JAX
    package were measured with."""
    shape = img.shape
    if on_card("sift", img):
        src = img.reshape(-1, *shape[-2:])
        out = torch.empty(src.shape, dtype=torch.float32, device=img.device)
        cuda_sift.level(src, _taps(float(sigma)).tolist(), out)
        return out.reshape(shape)
    k = torch.from_numpy(_taps(float(sigma)))
    r = (k.shape[0] - 1) // 2
    x = img.reshape(-1, 1, *shape[-2:])
    x = F.pad(x, (0, 0, r, r), mode="reflect").unfold(2, 2 * r + 1, 1) @ k
    x = F.pad(x, (r, r, 0, 0), mode="reflect").unfold(3, 2 * r + 1, 1) @ k
    return x.reshape(shape)


def blur_in_tap_order(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """The SIFT level kernel's plain twin: every output the sum of its 2r+1
    products, added in tap order by one elementwise pass per tap."""
    taps = [float(t) for t in _taps(float(sigma))]
    r = (len(taps) - 1) // 2
    shape = img.shape
    h, w = shape[-2:]
    x = F.pad(img.reshape(-1, 1, h, w), (0, 0, r, r), mode="reflect")
    acc = x[..., :h, :] * taps[0]
    for i in range(1, 2 * r + 1):
        acc = acc + x[..., i:i + h, :] * taps[i]
    x = F.pad(acc, (r, r, 0, 0), mode="reflect")
    acc = x[..., :w] * taps[0]
    for i in range(1, 2 * r + 1):
        acc = acc + x[..., i:i + w] * taps[i]
    return acc.reshape(shape)


def _level_sigmas(config: FrontendConfig):
    """An octave's level sigmas and the blur from each level to the next."""
    s, sig0 = config.scales_per_octave, config.init_sigma
    sigmas = [sig0 * (2.0 ** (i / s)) for i in range(s + 3)]
    deltas = [float((sigmas[i] ** 2 - sigmas[i - 1] ** 2) ** 0.5) for i in range(1, s + 3)]
    return sigmas, deltas


@functools.lru_cache(maxsize=32)
def _constants(device: torch.device, config: FrontendConfig, h: int, w: int):
    """What detection needs besides the images, made once for each device,
    configuration and image size: the octaves' (oh, ow) (an octave under
    17x17 ends the pyramid: the orientation stage reads a 17x17 patch), the
    detection sigmas 1..s, and the octaves' heights and widths on the
    device."""
    shapes = []
    for _ in range(config.num_octaves):
        if h < 17 or w < 17:
            break
        shapes.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    if not shapes:
        raise ValueError(f"SIFT needs images of at least 17x17, got {h}x{w}")
    sigmas, _ = _level_sigmas(config)
    s = config.scales_per_octave
    return (tuple(shapes),
            torch.tensor(sigmas[1:1 + s], dtype=torch.float32, device=device),
            torch.tensor([sh[0] for sh in shapes], device=device),
            torch.tensor([sh[1] for sh in shapes], device=device))


class ScaleSpace(NamedTuple):
    """The dense planes detection reads, for B images."""
    gauss: List[torch.Tensor]      # per octave (B, s+3, oh, ow): the Gaussian levels
    dog: List[torch.Tensor]        # per octave (B, s, oh, ow): the DoG planes 1..s
    response: List[torch.Tensor]   # per octave (B, s, oh, ow): |DoG| at kept extrema, else 0
    mag: torch.Tensor              # (B, n_oct * s, H0, W0): gradient magnitude of the
    ang: torch.Tensor              # levels 1..s, each octave zero-padded; and its angle


def _build_pyramid(gray: torch.Tensor, config: FrontendConfig, blur):
    """Per octave: the Gaussian stack (B, s+3, oh, ow) and its DoG planes."""
    s = config.scales_per_octave
    shapes = _constants(gray.device, config, *gray.shape[-2:])[0]
    _, deltas = _level_sigmas(config)
    out = []
    octave_img = blur(gray, config.init_sigma)
    for _ in shapes:
        gauss = [octave_img]
        for delta in deltas:
            gauss.append(blur(gauss[-1], delta))
        G = torch.stack(gauss, dim=1)
        out.append((G, G[:, 1:] - G[:, :-1]))
        octave_img = G[:, s, ::2, ::2]
    return out


def _octave_response(dog, config: FrontendConfig):
    """The DoG planes 1..s of one octave and their response: |DoG| at the
    scale-space extrema that pass the contrast, edge and border tests, else 0."""
    B, ns, oh, ow = dog.shape
    center = dog[:, 1:-1]
    neigh_max = torch.full_like(center, -math.inf)
    neigh_min = torch.full_like(center, math.inf)
    for ds in (-1, 0, 1):
        plane = dog[:, 1 + ds: ns - 1 + ds]
        for dy in (-1, 0, 1):
            py = torch.roll(plane, -dy, dims=2)
            for dx in (-1, 0, 1):
                if ds == 0 and dy == 0 and dx == 0:
                    continue
                p = torch.roll(py, -dx, dims=3)
                neigh_max = torch.maximum(neigh_max, p)
                neigh_min = torch.minimum(neigh_min, p)
    is_extremum = (center > neigh_max) | (center < neigh_min)
    contrast_ok = torch.abs(center) > (config.contrast_threshold / config.scales_per_octave)

    # edge rejection: 2x2 spatial Hessian ratio (reference edgeThreshold)
    def shift(x, sy, sx):
        return torch.roll(x, (-sy, -sx), dims=(2, 3))

    dxx = shift(center, 0, 1) - 2 * center + shift(center, 0, -1)
    dyy = shift(center, 1, 0) - 2 * center + shift(center, -1, 0)
    dxy = (shift(center, 1, 1) - shift(center, 1, -1)
           - shift(center, -1, 1) + shift(center, -1, -1)) / 4.0
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = config.edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

    margin = 8
    ys = torch.arange(oh, device=dog.device)
    xs = torch.arange(ow, device=dog.device)
    border_ok = (((ys[:, None] >= margin) & (ys[:, None] < oh - margin))
                 & ((xs[None, :] >= margin) & (xs[None, :] < ow - margin)))

    good = is_extremum & contrast_ok & edge_ok & border_ok
    return center, torch.where(good, torch.abs(center), 0.0)


def _octave_planes(G, dog, config: FrontendConfig):
    """One octave's detection planes from its Gaussian stack and DoG planes:
    the DoG planes 1..s, their response, and the gradient magnitude and
    angle of the levels 1..s (central differences, wrapping at the border)."""
    center, response = _octave_response(dog, config)
    Gsel = G[:, 1:-2]
    gx = (torch.roll(Gsel, -1, 3) - torch.roll(Gsel, 1, 3)) / 2.0
    gy = (torch.roll(Gsel, -1, 2) - torch.roll(Gsel, 1, 2)) / 2.0
    return center, response, sqrt_rn(gx * gx + gy * gy), torch.atan2(gy, gx)


def scale_space_plain(gray: torch.Tensor, config: FrontendConfig = FrontendConfig(),
                      blur=blur_in_tap_order) -> ScaleSpace:
    """The scale space of (B, H, W) float32 images by PyTorch ops: the SIFT
    kernels' plain twin with ``blur_in_tap_order``, on any device; the CPU
    route with ``gaussian_blur``."""
    pyr = _build_pyramid(gray, config, blur)
    h0, w0 = pyr[0][0].shape[-2:]
    centers, responses, mags, angs = [], [], [], []
    for G, dog in pyr:
        oh, ow = G.shape[-2:]
        center, response, mag, ang = _octave_planes(G, dog, config)
        centers.append(center)
        responses.append(response)
        pad = (0, w0 - ow, 0, h0 - oh)
        mags.append(F.pad(mag, pad))
        angs.append(F.pad(ang, pad))
    return ScaleSpace([G for G, _ in pyr], centers, responses, torch.cat(mags, dim=1),
                      torch.cat(angs, dim=1))


def scale_space_kernel(gray: torch.Tensor, config: FrontendConfig = FrontendConfig()
                       ) -> ScaleSpace:
    """``scale_space_plain`` by the SIFT kernels (``ops/cuda_sift.py``):
    one launch a Gaussian level, written into its octave's stack (the next
    octave's first level read at stride 2 from level s and copied into
    plane 0 in the same launch), and one launch an octave for the DoG,
    response and gradient planes."""
    B, h0, w0 = gray.shape
    s = config.scales_per_octave
    shapes = _constants(gray.device, config, h0, w0)[0]
    _, deltas = _level_sigmas(config)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=gray.device)

    # the detection writes each octave's (oh, ow) corner of its slots
    grads = torch.zeros(2, B, len(shapes) * s, h0, w0, device=gray.device)
    out = ScaleSpace([], [], [], grads[0], grads[1])
    contrast = config.contrast_threshold / s
    for octave, (oh, ow) in enumerate(shapes):
        G = empty(B, s + 3, oh, ow)
        if octave == 0:
            cuda_sift.level(gray, _taps(float(config.init_sigma)).tolist(), G[:, 0])
            cuda_sift.level(G[:, 0], _taps(deltas[0]).tolist(), G[:, 1])
        else:
            cuda_sift.level(out.gauss[-1][:, s, ::2, ::2], _taps(deltas[0]).tolist(), G[:, 1],
                            copy=G[:, 0])
        for i in range(2, s + 3):
            cuda_sift.level(G[:, i - 1], _taps(deltas[i - 1]).tolist(), G[:, i])
        dog, response = empty(B, s, oh, ow), empty(B, s, oh, ow)
        cuda_sift.detect(G, dog, response, out.mag, out.ang, octave * s, contrast,
                         config.edge_threshold)
        out.gauss.append(G)
        out.dog.append(dog)
        out.response.append(response)
    return out


def scale_space(gray: torch.Tensor, config: FrontendConfig = FrontendConfig()) -> ScaleSpace:
    """The scale space of (B, H, W) float32 images: the SIFT kernels for a
    CUDA tensor, 25 launches at the default configuration; PyTorch ops with
    the matmul blur for a CPU tensor."""
    if on_card("sift", gray):
        return scale_space_kernel(gray, config)
    return scale_space_plain(gray, config, gaussian_blur)


def _top_k(values: torch.Tensor, k: int):
    """Largest k along the last axis, ties to the lower index (lax.top_k)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _octave_candidates(center, response, sigs, octave, K: int):
    """Top-K scale-space extrema of one octave for each image of the batch."""
    B, _, oh, ow = center.shape
    stride = 2.0 ** octave
    top_vals, top = _top_k(response.reshape(B, -1), K)
    valid = top_vals > 0
    si, yi, xi = top // (oh * ow), (top // ow) % oh, top % ow

    # quadratic sub-pixel refinement in x and y
    b = torch.arange(B, device=center.device)[:, None]
    c = center[b, si, yi, xi]

    def subpix(p, m):
        denom = p - 2 * c + m
        off = torch.where(torch.abs(denom) > 1e-8, -0.5 * (p - m) / denom, 0.0)
        return torch.clamp(off, -0.5, 0.5)

    off_y = subpix(center[b, si, torch.clamp(yi + 1, max=oh - 1), xi],
                   center[b, si, torch.clamp(yi - 1, min=0), xi])
    off_x = subpix(center[b, si, yi, torch.clamp(xi + 1, max=ow - 1)],
                   center[b, si, yi, torch.clamp(xi - 1, min=0)])

    kp_x = (xi.to(torch.float32) + off_x) * stride
    kp_y = (yi.to(torch.float32) + off_y) * stride
    return (torch.stack([kp_x, kp_y], dim=-1), sigs[si] * stride, top_vals, valid,
            si, yi, xi)


def _detect(gray: torch.Tensor, config: FrontendConfig, space: ScaleSpace):
    """Per-octave extrema of the scale space, the global top-K, and the
    gradient stack (B, n_oct * s, H0, W0) that orientation and descriptors
    read (each octave's planes zero-padded to the octave-0 shape)."""
    K = config.max_keypoints
    s = config.scales_per_octave
    _, sigs, oh_arr, ow_arr = _constants(gray.device, config, *gray.shape[-2:])
    per_oct = [_octave_candidates(center, response, sigs, octave, K)
               for octave, (center, response) in enumerate(zip(space.dog, space.response))]

    def cat(i):
        return torch.cat([c[i] for c in per_oct], dim=1)

    xy, scale, resp, valid, si, yi, xi = (cat(i) for i in range(7))
    oi = torch.cat([torch.full_like(c[4], o) for o, c in enumerate(per_oct)], dim=1)
    _, top = _top_k(torch.where(valid, resp, -math.inf), K)

    def pick(x):
        return torch.gather(x, 1, top if x.ndim == 2 else top[..., None].expand(-1, -1, 2))

    oi_w = pick(oi)
    return {
        "xy": pick(xy), "scale": pick(scale), "response": pick(resp),
        "valid": pick(valid), "plane": oi_w * s + pick(si), "si": pick(si),
        "yi": pick(yi), "xi": pick(xi), "mag": space.mag, "ang": space.ang, "sigs": sigs,
        "oh": oh_arr[oi_w], "ow": ow_arr[oi_w],
    }


def _orientation(mag, ang, b, plane, si, yi, xi, sigs, oh, ow):
    """Dominant gradient orientation: the peak of a smoothed 36-bin
    histogram over a Gaussian-weighted 17x17 patch."""
    R = _R_ORI
    dd = torch.arange(-R, R + 1, device=mag.device)
    ys = torch.minimum(torch.clamp(yi, min=R), oh - R - 1)
    xs = torch.minimum(torch.clamp(xi, min=R), ow - R - 1)
    rows = (ys[..., None] + dd)[..., :, None]                  # (B, K, 17, 1)
    cols = (xs[..., None] + dd)[..., None, :]                  # (B, K, 1, 17)
    at = (b[..., None, None], plane[..., None, None], rows, cols)
    m, a = mag[at], ang[at]                                    # (B, K, 17, 17)

    dy = dd.to(torch.float32)[:, None]
    dx = dd.to(torch.float32)[None, :]
    wgt = torch.exp(-(dy * dy + dx * dx) / (2 * (1.5 * sigs[si]) ** 2)[..., None, None])
    bins = torch.floor((a + math.pi) / (2 * math.pi) * 36).to(torch.int64) % 36
    shape = m.shape[:2] + (-1,)
    hist = torch.zeros(m.shape[:2] + (36,), device=m.device).scatter_add_(
        -1, bins.reshape(shape), (m * wgt).reshape(shape))
    hist = (torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1)) / 3.0
    peak = torch.argmax(hist, dim=-1)
    return (peak.to(torch.float32) + 0.5) / 36.0 * 2 * math.pi - math.pi


def _descriptor(mag, ang, b, plane, si, yi, xi, sigs, ori, oh, ow):
    """4x4 spatial x 8 orientation descriptor from a rotated 16x16 sample
    grid with spacing 0.75 sigma."""
    device = mag.device
    spacing = 0.75 * sigs[si]                                   # (B, K)
    g = torch.arange(_GRID, dtype=torch.float32, device=device) - (_GRID - 1) / 2
    gy2, gx2 = torch.meshgrid(g, g, indexing="ij")
    gy = gy2.reshape(-1) * spacing[..., None]                   # (B, K, 256)
    gx = gx2.reshape(-1) * spacing[..., None]
    ct = torch.cos(ori)[..., None]
    st = torch.sin(ori)[..., None]
    sx = xi.to(torch.float32)[..., None] + ct * gx - st * gy
    sy = yi.to(torch.float32)[..., None] + st * gx + ct * gy
    h_lim, w_lim = oh[..., None], ow[..., None]
    bb, pp = b[..., None], plane[..., None]

    # bilinear magnitude taps: x0 = clip(floor(sx), 0, w-2), unclipped fraction
    x0f = torch.floor(sx)
    fx = sx - x0f
    x0 = torch.minimum(torch.clamp(x0f, min=0), (w_lim - 2).to(x0f.dtype)).to(torch.int64)
    y0f = torch.floor(sy)
    fy = sy - y0f
    y0 = torch.minimum(torch.clamp(y0f, min=0), (h_lim - 2).to(y0f.dtype)).to(torch.int64)
    top = mag[bb, pp, y0, x0] * (1 - fx) + mag[bb, pp, y0, x0 + 1] * fx
    bottom = mag[bb, pp, y0 + 1, x0] * (1 - fx) + mag[bb, pp, y0 + 1, x0 + 1] * fx
    m = top * (1 - fy) + bottom * fy

    # nearest-neighbour angle taps (angles do not interpolate across the wrap)
    xn = torch.minimum(torch.clamp(torch.round(sx), min=0),
                       (w_lim - 1).to(sx.dtype)).to(torch.int64)
    yn = torch.minimum(torch.clamp(torch.round(sy), min=0),
                       (h_lim - 1).to(sy.dtype)).to(torch.int64)
    a = ang[bb, pp, yn, xn] - ori[..., None]

    sig_w = _GRID * spacing / 2.0
    wgt = torch.exp(-(gx * gx + gy * gy) / (2 * sig_w * sig_w)[..., None])
    cell = torch.arange(_GRID, device=device) // (_GRID // 4)
    spatial = (cell[:, None] * 4 + cell[None, :]).reshape(-1)  # (256,) in [0, 16)
    obin = torch.floor((a + math.pi) / (2 * math.pi) * 8).to(torch.int64) % 8
    d = torch.zeros(m.shape[:2] + (128,), device=device).scatter_add_(
        -1, spatial * 8 + obin, m * wgt)

    def normalise(v):
        return v / torch.clamp_min(sqrt_rn(torch.sum(v * v, dim=-1, keepdim=True)), 1e-8)

    return normalise(torch.clamp(normalise(d), max=0.2))


def _gray(images: torch.Tensor) -> torch.Tensor:
    return (rgb_to_gray(images) if images.ndim == 4 else images.to(torch.float32)) / 255.0


def _describe(gray: torch.Tensor, config: FrontendConfig, space: ScaleSpace) -> Keypoints:
    det = _detect(gray, config, space)
    B, K = det["yi"].shape
    b = torch.arange(B, device=gray.device)[:, None].expand(B, K)
    args = (det["mag"], det["ang"], b, det["plane"], det["si"], det["yi"], det["xi"],
            det["sigs"])
    ori = _orientation(*args, det["oh"], det["ow"])
    desc = _descriptor(*args, ori, det["oh"], det["ow"])
    return Keypoints(xy=det["xy"], scale=det["scale"], response=det["response"],
                     orientation=ori, descriptors=desc, valid=det["valid"])


def detect_and_describe_batch(images: torch.Tensor,
                              config: FrontendConfig = FrontendConfig()) -> Keypoints:
    """Keypoints of a batch of equally sized images, (B, H, W, 3) or
    (B, H, W); every field gets a leading batch axis."""
    gray = _gray(images)
    return _describe(gray, config, scale_space(gray, config))


def detect_and_describe_plain(images: torch.Tensor,
                              config: FrontendConfig = FrontendConfig()) -> Keypoints:
    """``detect_and_describe_batch`` with the scale space of the kernels'
    plain twin (``scale_space_plain``), on any device."""
    gray = _gray(images)
    return _describe(gray, config, scale_space_plain(gray, config))


def detect_and_describe(image: torch.Tensor,
                        config: FrontendConfig = FrontendConfig()) -> Keypoints:
    """Keypoints of one (H, W, 3) or (H, W) image."""
    kp = detect_and_describe_batch(image[None], config)
    return Keypoints(*(x[0] for x in kp))
