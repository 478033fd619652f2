"""The benchmark's inputs, made from a seed.

``nonplanar_scene`` is a vectorised copy of ``chip_smoke.nonplanar_scene``
(the same draws from the same NumPy generator, the same images): two
calibrated cameras over a smooth surface textured with Gaussian blobs.
The smoke renders the blobs in a Python loop (about 4 s a 750x900 pair on
a CPU); here every blob is one slot of a fixed 98x98 stamp, added into
the texture with one scatter per chunk of blobs, and the right view's
fixed-point search runs on ``device``.

``rectified_pair`` sees the same kind of blob texture through rectified
cameras: the right pixel (x, y) shows the left point (x + d(x, y), y),
with a smooth true disparity d over most of ``[0, max_disparity)``.

``derive`` turns a run's seed and a few keys into the seed of one draw.
"""

from __future__ import annotations

import numpy as np
import torch

SUPERSAMPLE = 4          # texture samples per pixel and axis
STAMP = 98               # >= 2 * 4 * max sigma * SUPERSAMPLE + 2
BLOB_CHUNK = 1024


def derive(seed: int, *keys: int) -> int:
    """A 63-bit seed from a run's seed (any whole number) and keys."""
    words = np.random.SeedSequence([int(k) % 2**64 for k in (seed, *keys)]).generate_state(2)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & (2**63 - 1)


def rodrigues(v):
    theta = np.linalg.norm(v)
    k = v / theta
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * Kx + (1 - np.cos(theta)) * Kx @ Kx


def camera_pair(h: int, w: int):
    """K with focal w, a small R, a unit T (the smoke's cameras)."""
    K = np.array([[float(w), 0, w / 2], [0, float(w), h / 2], [0, 0, 1]])
    R = rodrigues(np.array([0.02, -0.08, 0.01]))
    T = np.array([-1.0, 0.05, 0.15])
    return K, R, T / np.linalg.norm(T)


def true_fundamental(K, R, T):
    """F = K^-T [T]x R K^-1 at unit norm."""
    Tx = np.array([[0, -T[2], T[1]], [T[2], 0, -T[0]], [-T[1], T[0], 0]])
    Kinv = np.linalg.inv(K)
    F = Kinv.T @ Tx @ R @ Kinv
    return F / np.linalg.norm(F)


def blob_texture(rng, h: int, w: int, device) -> torch.Tensor:
    """(h * 4, w * 4) float64 texture: 128 plus h * w // 80 Gaussian blobs,
    each cut to its 4-sigma box (the smoke's draws, in its order)."""
    ss = SUPERSAMPLE
    n_blobs = h * w // 80
    cy, cx = rng.uniform(0, h, n_blobs), rng.uniform(0, w, n_blobs)
    amp = rng.uniform(40, 120, n_blobs) * rng.choice([-1.0, 1.0], n_blobs)
    sig = rng.uniform(1.0, 3.0, n_blobs)
    r = 4 * sig
    # the smoke's box: [max(0, int((c - r) ss)), min(n ss, int((c + r) ss) + 1))
    y0 = np.maximum(0, ((cy - r) * ss).astype(np.int64))
    y1 = np.minimum(h * ss, ((cy + r) * ss).astype(np.int64) + 1)
    x0 = np.maximum(0, ((cx - r) * ss).astype(np.int64))
    x1 = np.minimum(w * ss, ((cx + r) * ss).astype(np.int64) + 1)
    f64 = dict(dtype=torch.float64, device=device)
    tex = torch.full((h * ss * w * ss,), 128.0, **f64)
    step = torch.arange(STAMP, device=device)
    for lo in range(0, n_blobs, BLOB_CHUNK):
        sl = slice(lo, lo + BLOB_CHUNK)
        t = {k: torch.as_tensor(v[sl], device=device)
             for k, v in dict(y0=y0, y1=y1, x0=x0, x1=x1).items()}
        c = {k: torch.as_tensor(v[sl], **f64)
             for k, v in dict(cy=cy, cx=cx, a=amp, s=sig).items()}
        rows = t["y0"][:, None] + step                       # (n, STAMP)
        cols = t["x0"][:, None] + step
        yy = rows.to(torch.float64) / ss - c["cy"][:, None]
        xx = cols.to(torch.float64) / ss - c["cx"][:, None]
        two_s2 = (2 * c["s"] * c["s"])[:, None, None]
        val = c["a"][:, None, None] * torch.exp(
            -(yy[:, :, None] * yy[:, :, None] + xx[:, None, :] * xx[:, None, :]) / two_s2)
        keep = (rows < t["y1"][:, None])[:, :, None] & (cols < t["x1"][:, None])[:, None, :]
        flat = rows[:, :, None] * (w * ss) + cols[:, None, :]
        tex.index_put_((flat[keep],), val[keep], accumulate=True)
    return tex.reshape(h * ss, w * ss)


def sensor(rng, img: torch.Tensor) -> np.ndarray:
    """Gaussian sensor noise (sigma 2) drawn on the host, clipped, rounded,
    as a (h, w, 3) uint8 image."""
    noise = torch.as_tensor(rng.normal(0, 2, tuple(img.shape)), device=img.device)
    img = torch.clamp(img + noise, 0, 255)
    return torch.round(img)[..., None].expand(*img.shape, 3).to(torch.uint8).cpu().numpy()


def bilinear(tex: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """The texture at pixel coordinates (px, py), bilinearly, from its
    supersampled grid (the smoke's sampling)."""
    ss = SUPERSAMPLE
    hs, ws = tex.shape
    sx, sy = px * ss, py * ss
    x0 = torch.clamp(torch.floor(sx).long(), max=ws - 2)
    y0 = torch.clamp(torch.floor(sy).long(), max=hs - 2)
    fx, fy = sx - x0, sy - y0
    return ((tex[y0, x0] * (1 - fx) + tex[y0, x0 + 1] * fx) * (1 - fy)
            + (tex[y0 + 1, x0] * (1 - fx) + tex[y0 + 1, x0 + 1] * fx) * fy)


def nonplanar_scene(rng, h: int = 750, w: int = 900, device="cpu"):
    """``chip_smoke.nonplanar_scene`` on ``device``: (left, right, K, R, T,
    F). The surface is Z = 10 + 8 (0.5 + 0.5 sin(6x/w) cos(4y/h)) over the
    left pixel (x, y); each right pixel takes the texture at the left point
    it sees, found by 40 fixed-point steps through the surface; right
    pixels that see none stay black."""
    K, R, T = camera_pair(h, w)
    F = true_fundamental(K, R, T)
    tex = blob_texture(rng, h, w, device)
    f64 = dict(dtype=torch.float64, device=device)
    Kt, Rt, Tt = (torch.as_tensor(a, **f64) for a in (K, R, T))
    Kinv = torch.linalg.inv(Kt)
    ys, xs = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64), indexing="ij")
    px, py = xs.clone(), ys.clone()
    ones = torch.ones(h * w, **f64)
    for _ in range(40):
        z = 10 + 8 * (0.5 + 0.5 * torch.sin(6 * px / w) * torch.cos(4 * py / h))
        X = z.reshape(-1) * (Kinv @ torch.stack([px.reshape(-1), py.reshape(-1), ones]))
        pr = Kt @ (Rt @ X + Tt[:, None])
        px = px - (pr[0] / pr[2]).reshape(h, w) + xs
        py = py - (pr[1] / pr[2]).reshape(h, w) + ys
    seen = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
    right = bilinear(tex, torch.where(seen, px, 0.0), torch.where(seen, py, 0.0))
    right = np.where(seen.cpu().numpy()[..., None], sensor(rng, right), 0).astype(np.uint8)
    left = sensor(rng, tex[::SUPERSAMPLE, ::SUPERSAMPLE])
    return left, right, K, R, T, F


def rectified_disparity(h: int, w: int, max_disparity: int, device="cpu") -> torch.Tensor:
    """(h, w) float64 true right-image disparity of ``rectified_pair``:
    smooth, from 5% to 95% of ``max_disparity``."""
    f64 = dict(dtype=torch.float64, device=device)
    ys, xs = torch.meshgrid(torch.arange(h, **f64), torch.arange(w, **f64), indexing="ij")
    shape = 0.5 + 0.5 * torch.sin(6 * xs / w) * torch.cos(4 * ys / h)
    return max_disparity * (0.05 + 0.9 * shape)


def rectified_pair(rng, h: int, w: int, max_disparity: int, device="cpu"):
    """A rectified (left, right) uint8 pair of the blob texture: right
    pixel (x, y) shows left point (x + d(x, y), y); right pixels whose
    point lies past the left image's edge stay black."""
    tex = blob_texture(rng, h, w, device)
    d = rectified_disparity(h, w, max_disparity, device)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device),
                            indexing="ij")
    px = xs + d
    seen = px <= w - 1
    right = bilinear(tex, torch.where(seen, px, 0.0), ys)
    right = np.where(seen.cpu().numpy()[..., None], sensor(rng, right), 0).astype(np.uint8)
    left = sensor(rng, tex[::SUPERSAMPLE, ::SUPERSAMPLE])
    return left, right
