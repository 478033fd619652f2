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
