"""Inputs and comparison rules shared by the port's tests and
``chip_smoke.py`` (which puts this directory on ``sys.path``). NumPy and
tensor methods only: nothing here imports JAX or either package."""

from __future__ import annotations

import numpy as np


def scan_volume(rng, h, w, d, ties=False):
    """A (d, h, w) float32 cost volume and an (h, w) black mask that drive
    every branch of the exact smoothing row scan: costs in [1, 1.25] (so the
    0.9 discount flips winners), +inf entries, pixels with no candidate
    (sentinel -x), cheap and exactly-zero d = 0 entries, black pixels.
    ``ties`` rounds the costs to 1/8, so equal values and the index rule
    decide."""
    cost = rng.uniform(1.0, 1.25, (d, h, w)).astype(np.float32)
    if ties:
        cost = np.round(cost * 8) / 8
    cost[rng.uniform(size=cost.shape) < 0.2] = np.inf
    cost[:, rng.uniform(size=(h, w)) < 0.15] = np.inf
    cost[0] = np.where(rng.uniform(size=(h, w)) < 0.3, 0.5, cost[0])
    cost[0] = np.where(rng.uniform(size=(h, w)) < 0.05, 0.0, cost[0])
    return cost, rng.uniform(size=(h, w)) < 0.1


def chain_planes(rng, h, w, d, ties=False):
    """The five planes of the exact smoothing row scan and a black mask,
    planted so that the case entering a run of pixels decides every pixel
    of it: a wrong case handed across a column boundary changes each pixel
    to its right. Returns float32 m0, int32 a0, float32 c_zero, diag_up,
    diag_lf and a bool black mask, each (h, w), in runs of 20 to 400
    columns of four kinds:

    * zero runs: d = 0 wins only where the left (or up) neighbour chose 0
      (c_zero just above m0, below it after the 0.9 discount; with
      ``ties`` c_zero equals m0 and the index rule decides at
      smooth_factor 1.0), so a 0 entering the run carries through it;
    * sentinel chains: no candidate of their own (m0 = +inf), but a left
      sentinel -x offers diag_lf, so the cases alternate none / sentinel
      and the entering case sets the phase of the whole run;
    * kicks: one pixel that always chooses 0 (c_zero 0.5) or is black,
      starting a zero run;
    * random pixels as in ``scan_volume``.

    About one row in eight is all black (every pixel 0: the next row's up
    neighbours all chose 0), and a few pixels elsewhere are black."""
    inf = np.float32(np.inf)
    m0 = np.full((h, w), inf, np.float32)
    a0 = np.zeros((h, w), np.int32)
    c_zero = np.full((h, w), inf, np.float32)
    diag_up = np.full((h, w), inf, np.float32)
    diag_lf = np.full((h, w), inf, np.float32)
    black = rng.uniform(size=(h, w)) < 0.01
    for y in range(h):
        x = 0
        while x < w:
            n = min(w - x, int(rng.integers(20, 401)))
            sl = slice(x, x + n)
            kind = rng.integers(0, 4)
            if kind == 0:                                   # zero run
                m0[y, sl] = 1.0
                a0[y, sl] = rng.integers(1, d, n)
                c_zero[y, sl] = 1.0 if ties else 1.05
            elif kind == 1:                                 # sentinel chain
                diag_lf[y, sl] = rng.uniform(1.0, 1.25, n)
                diag_up[y, sl] = np.where(rng.uniform(size=n) < 0.5, inf,
                                          rng.uniform(1.0, 1.25, n))
            elif kind == 2:                                 # a kick, then a zero run
                m0[y, sl] = 1.0
                a0[y, sl] = rng.integers(1, d, n)
                c_zero[y, sl] = 1.0 if ties else 1.05
                if rng.uniform() < 0.5:
                    c_zero[y, x] = 0.5
                else:
                    black[y, x] = True
            else:                                           # random pixels
                m0[y, sl] = rng.uniform(1.0, 1.25, n)
                a0[y, sl] = rng.integers(0, d, n)
                c_zero[y, sl] = np.where(rng.uniform(size=n) < 0.3, 0.5,
                                         rng.uniform(1.0, 1.25, n))
                diag_up[y, sl] = rng.uniform(1.0, 1.25, n)
                diag_lf[y, sl] = rng.uniform(1.0, 1.25, n)
            x += n
        if rng.uniform() < 0.125:
            black[y] = True
    if ties:
        for p in (m0, c_zero, diag_up, diag_lf):
            p[np.isfinite(p)] = np.round(p[np.isfinite(p)] * 8) / 8
    return m0, a0, c_zero, diag_up, diag_lf, black


# K1b's widths worth testing: a strip is one warp of 64 columns, and up to 8
# strips a launch are one CTA each (512 columns); wider rows put 2 to 16
# strips in each of 8 CTAs, up to K1b's widest row, 8192
STRIP_WIDTHS = (1, 31, 32, 33, 63, 64, 65, 511, 512, 513, 1408, 4096, 4097, 8192)


def seed_rows(rng, h, w, d):
    """Seeded-scan arguments: (h,) bool first flags (30% set) and a (w,)
    float32 seed row of zeros, sentinels -x and disparities below d."""
    xs = np.arange(w, dtype=np.float32)
    seed = np.choose(rng.integers(0, 3, w), [np.zeros(w, np.float32), -xs,
                                             rng.integers(0, d, w)]).astype(np.float32)
    return rng.random(h) < 0.3, seed


def halo_tile(img, row0, n):
    """Rows row0 .. row0 + n - 1 of the (H, W, C) tensor ``img``, zeros
    outside it: a halo-extended row tile as the sharded matcher builds it."""
    h = img.shape[0]
    out = img.new_zeros((n,) + tuple(img.shape[1:]))
    lo, hi = max(row0, 0), min(row0 + n, h)
    if hi > lo:
        out[lo - row0:hi - row0] = img[lo:hi]
    return out


def scale_aligned(got_poses, got_points, want_points):
    """Translations and points of a multi-view solve times the one scale
    factor that best maps its points onto ``want_points``: only camera 0 is
    pinned, so the scale is a gauge freedom along which the damped solve
    amplifies rounding (ROADMAP.md, Queue 3). Returns (poses, points,
    the factor); callers bound the factor's distance from 1 as well."""
    a, b = got_points.astype(np.float64), want_points.astype(np.float64)
    s = (a * b).sum() / (a * a).sum()
    poses = got_poses.astype(np.float64).copy()
    poses[:, 3:] *= s
    return poses, s * a, s


def warp_images(rng, case):
    """Two images of one of the inputs the twin takes beyond uint8 and
    float32 contiguous (h, w[, 1 or 3]): another dtype, a view, other
    channel counts, a uint8 and a float32 image together."""
    import torch

    def a(shape, dtype=np.float32):
        return torch.from_numpy((rng.integers(0, 256, shape) if dtype == np.uint8 else
                                 rng.uniform(-20, 300, shape)).astype(dtype))

    if case == "float64":
        return [a((30, 40, 3), np.float64), a((25, 33, 3), np.float64)]
    if case == "int16":
        return [a((30, 40), np.int16), a((25, 33), np.int16)]
    if case == "view":           # a transposed and a strided view
        return [a((40, 30, 3)).transpose(0, 1), a((50, 33, 3))[::2]]
    if case in ("2ch", "4ch", "1ch"):
        c = {"1ch": 1, "2ch": 2, "4ch": 4}[case]
        return [a((30, 40, c), np.uint8), a((25, 33, c), np.uint8)]
    assert case == "mixed"
    return [a((30, 40, 3), np.uint8), a((25, 33, 3))]


WARP_IMAGE_CASES = ["float64", "int16", "view", "1ch", "2ch", "4ch", "mixed"]
