#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``stereo_reconstruction_tpu_torch`` on ``cuda:0`` and fails (exit
code 1, no result line) if anything is off:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: K1 (``csrc/matcher_inputs.cu``), K1b (``csrc/row_scan.cu``),
   K2 (``csrc/cost_volume.cu``), K3 (``csrc/block_search.cu``) and K4
   (``csrc/perceptual_scan.cu``) with one ``nvcc`` each for ``sm_90a``,
   all started together;
3. K1, K2 and K1b against their plain PyTorch twins on the card at four
   shapes — (a) 375x450, D=100, block 17 (MiddEval3 trainingQ), (b) the
   1128x1408 rectified canvas of a 750x900 pair, D=200, block 17 (the
   reference's operating point, main.cpp:40), (c) H=21, W=40, WL=49,
   min_d=2, block 5 — on integer-valued pairs, where K1's five planes,
   K2's volume (+inf pattern included) and K1b's disparity from K1's
   planes must be bit equal; (d) 101x200, D=30, min_d=1, block 9, puts an
   interior K1 tile's band at the image bottom, where the overrun slots of
   its band loads must load nothing; then K1b on planted random planes (W
   from 1 to 8192) and on chain planes (``tests/torch_helpers.chain_planes``:
   runs whose every pixel the entering case decides) at widths around its
   64-column strips and 512-column one-warp clusters up to 8192, heights 1,
   2, 282 and 1128; median kernel and plain ms over 5 timed runs after a
   warm-up, and K1b's chain at (b): one 64-column strip alone (the
   strip-step) against the whole canvas (the hand-offs, the fill and
   warps sharing an SM);
4. the matcher against a literal NumPy recurrence on a small pair;
5. the slice: ``run_pair(fixed_F=F)`` on a synthetic 750x900 pair with
   a known F at the default config (block 17, D=200, outlier kernel 500),
   with exactly one K1, one K1b and two warp launches and no K2 or K3
   launch per call, the three staged artefacts, ``evaldisp`` against the
   scene's true disparity, and >= 99.5% disparity agreement with the plain
   backend (whose warps are the kernel's too); median stage times over 3
   runs after a warm-up; K1b bit-equal to the plain scan on the slice's
   own K1 planes; the warp kernel bit-equal to its plain twin on the card
   on the slice's own pair (both 750x900x3 images onto the 1128x1408
   canvas in one launch, bilinear, and the canvas's disparity back to
   750x900, nearest), each timed beside the twin;
6. K2's path on the slice's own rectified canvas, as
   ``tools/tpu_validate.py`` runs it: the volume, reduced by
   ``volume_reductions`` and K1b to a disparity. The reductions must equal
   K1's five planes, and the disparity the K1 route's, bit for bit;
7. K3 against its twin on integer-valued pairs, bit equal: shape (c),
   two tiles with a tile width that does not divide W at
   ``row_smooth_iters`` 1, 2, 3 and every ``smooth_mode``, three
   512-wide tiles at block 17, ``smooth_factor`` 0 at three seeds (a NaN
   from +inf * 0 wins the minimum: column 37 takes -37), 2-pixel tiles at
   3 sweeps (each tile boundary chains to the one before), shape (d), and
   a 4200-wide row;
8. K3's path at full width: the rectified canvas, D=200, block 17,
   ``tile_width`` 512 (3 tiles), equal to itself over two runs, >= 99.5%
   agreement with its twin (the canvas is not integer-valued) and >= 98%
   with the exact K1 route (the JAX package's two-tile bound,
   tests/test_pallas_kernel.py); median K3 and twin ms over 5 runs, K3
   against K1 + K1b on the same canvas, and a profiled K3 call split by
   kernel (layout pass, cost pass, row chain);
9. the whole chain, ``run_pair()`` with no F, on the 750x900 non-planar
   scene (``nonplanar_scene``) at the default config (500 keypoints, 256
   RANSAC hypotheses, BA over 60 points, D=200, block 17): exactly one K1,
   one K1b, two warp and two RANSAC launches (four on the first call, which
   captures the pose stage's graphs) and no K2 or K3 launch; a valid pose
   with enough points,
   ``pose_ok``, rotation < 0.5 deg and translation direction < 2 deg from
   the truth, BA reprojection error < 1 px; evaldisp total-bad < 20%
   against the true disparity; the 4x4 pose staged and reloaded; the same
   pose on three more runs, whose median stage times are printed; the
   port's CPU ``estimate_pose`` (same draws) within 0.05 deg in rotation
   and 0.2 deg in translation direction; the RANSAC kernel on the run's
   own matches and draws (recomputed, and giving the run's RANSAC pose bit
   for bit) against its twin with its rounding pinned
   (``tests/ransac_twin.py``: equal samples, winner and fit, inlier counts
   within 1, E, R and T within 1e-4), timed beside the twin's CUDA graph;
   a profile of the pose stage;
10. the batched main path, ``run_batch``, B = 4 at 750x900, D=200, block
   17: ``nonplanar_scene`` at seeds 0-2 and the flat-row pair
   (``flat_pair``, no keypoints) padded to 750x900. ``pose_ok`` 1, 1, 1, 0;
   each good pair's bad-2.0 < 20% against its true disparity; int16-exact
   disparities; >= 99.5% agreement with the same batch on the plain
   backend (same draws), of each good pair with itself in a batch of one,
   and of the masked batch with the batch without the degenerate pair;
   exactly 4 K1, 4 K1b, 2 warp and 2 RANSAC launches (2 and 2 a shard on a
   mesh) and no K2 or K3 launch, counted by the
   wrappers and seen by torch.profiler; stage times and pairs/s at B = 1
   and 4 (median of 3 after a warm-up);
11. the command line: a MiddEval3-shaped tree of one 750x900 scene
   (``write_middeval_scene``, PNGs by a stdlib writer) and ``python -m
   stereo_reconstruction_tpu_torch run``, ``run --batch`` and ``eval`` as
   subprocesses: ``run``'s staged disparity >= 99.5% equal to an in-process
   ``run_pair`` of the loaded pair, ``run --batch`` posed, ``eval`` equal
   to the in-process ``evaldisp`` (1e-5); which PNG readers exist;
12. the dense variants on the slice's rectified 1128x1408 canvas, D=200,
   block 17: SAD, NCC and the variable block (sizes 17, 21, 25) through
   ``block_search_right``, each with exactly one K1b launch and K1b equal
   to the plain scan on the same volume's planes; ``run_pair(fixed_F=F)``
   with SAD and NCC (evaldisp bad-2.0 < 20% against the true disparity)
   and ``run_batch`` with NCC; ``block_search_left`` (the fixpoint
   smoother, no kernel) and ``linear_search`` (one K1b launch) >= 99.5%
   equal to the port on the CPU on a 240x320 crop; each route's ms and the
   Left volume's;
13. the uncalibrated path: ``run_uncalibrated`` on ``nonplanar_scene``
   seed 0 at 750x900 (D=200) with orb, brisk and dog: >= 30 inliers,
   epipolar alignment <= 2.0 px, F re-estimated, the three PNGs, one K1b
   launch (``linear_search``) each; and
   ``python -m stereo_reconstruction_tpu_torch rectify`` as a subprocess
   on a MiddEval3 tree of the scene, with the in-process orb run's inliers;
14. the perceptual matcher (BASELINE config 3) at 375x450, D=100, window
   17, chunk 20, full VGG-16 widths with the seed-0 He-init weights: K4
   bit-equal to its twin on planted volumes (``perceptual_volume``: ties,
   NaN and +-0.0, H 1 to 6, W 1 to 700, D 7 to 600, chunk 1 to 150, 0 to 4
   staged rows, the clamp ``mean == size``) and on the scene's windowed
   volume, and K4's chain (one chunk strip alone); the windowed search on a random texture
   shifted by 9 px (``perceptual_pair``) with one K4 launch and >= 95% of
   interior pixels within 1 px of 9; the port's notebook oracle, fed the
   search's own row y-1, 100% within 2 px and >= 98% exact on rows 11,
   131, 252 and 304 (rows 370 and 373 printed); ``full_image`` mode's ms
   and agreement; ``run_pair(fixed_F=F)`` with the perceptual cost on
   the plane scene at 375x450 (one K4 launch, >= 99.5% equal to a direct
   windowed search on the same rectified pair, back-warped); and ``python
   -m stereo_reconstruction_tpu_torch run --matcher perceptual`` as a
   subprocess on a MiddEval3 tree of that scene;
15. the multi-device layer (``parallel/``) on a data=2, tile=4 mesh over
   ``cuda:0`` x 8, two integer-valued pairs at 1128x1408, D=200, block 17
   (282 rows a tile): K1 and K2 in global-row mode bit-equal to their
   twins on every halo-extended tile (the exact mode's and the warm-up
   mode's) and, the kept rows stitched, to K1 / K2 on the whole image;
   K1b seeded (``first_flags``, ``init_prev``) bit-equal to its twin on
   planted planes from one strip to 8192 columns, on the chain planes of
   phase 3 and on the matcher's own seeded and warm-up tiles of the pair,
   and a chain of seeded tiles to one launch; the exact
   ``sharded_block_search_right`` bit-identical to ``block_search_right``
   of each pair with 8 K1 and 32 K1b launches (one K1 per pair and tile, 4
   seeded passes each), the warm-up mode >= 99.5% equal with 8 + 8;
   ``sharded_evaldisp`` against ``evaldisp``; the distributed BAs on the
   non-planar scene's BA matches against ``bundle_adjust`` and the
   per-pair solves; the multi-view BA over the mesh against one device
   (rotations as they are, translations and points up to the scale
   gauge, its factor within 5e-3 of 1) and ``fuse_point_cloud``; and a
   one-process NCCL group
   (``multihost``, a ``file://`` store) running the exact matcher equal
   to the one-process mesh.

``python3 chip_smoke.py --time-kernels [K1 K1b K2 K3 K4 warp ransac]`` times K1,
K1b, K2 and K3 at shape (b), K4 at 375x450 (D=100 and 200, and one strip
alone), the warp kernel at the fixed-F request's shapes and the RANSAC
kernel at the posed request's (N = 500, 256 hypotheses), or only the
kernels named, and prints one JSON line (``time_kernels``).

Each path (5, 6, 8, 9, 10, 12, 13, 14, 15) runs with every launch count
(K1 to K4, the warp and RANSAC) set to 0 just before it and read just
after: two RANSAC launches a posed ``run_pair`` and a ``run_batch`` shard,
none a fixed-F request; the
launches made to compare a kernel with its twin are not counted. The line before the last is ``{"kernels": [...]}``, each
kernel with its bound (the larger of its bytes over 3.35 TB/s and its
float32 operations over 67 TFLOP/s, counted for this run's inputs by
``stereo_reconstruction_tpu_torch/utils/roofline.py``); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
from torch_helpers import (STRIP_WIDTHS, chain_planes, halo_tile, scale_aligned,  # noqa: E402
                           scan_volume, seed_rows)

SEED = 0
REPEATS = 5
# kernel launches per timed sample (one host call would time the enqueue)
CALLS = 10
# bound on evaldisp's bad-2.0 + invalid share against the synthetic scene's
# true disparity (a 180x150 cut of the scene on the CPU gives 7.9%)
MAX_TOTAL_BAD = 20.0


def _random_stereo(rng, h, w, max_d=8, noise=6, wl_extra=0):
    """Integer-valued pair: the right image is the smoothed random left
    image shifted by a smoothly varying disparity, plus noise, with a black
    border strip (as tests/test_block_search.py::_random_stereo)."""
    left = rng.integers(10, 250, (h, w, 3)).astype(np.float64)
    for _ in range(2):
        left = (left + np.roll(left, 1, 0) + np.roll(left, 1, 1)
                + np.roll(left, -1, 0)) / 4
    left = left.astype(np.uint8)
    disp = (max_d / 2 + (max_d / 3) * np.sin(np.arange(w) / 7))[None, :].repeat(h, 0)
    xs = np.arange(w)[None, :].repeat(h, 0)
    src = np.clip(xs + np.round(disp).astype(int), 0, w - 1)
    right = left[np.arange(h)[:, None], src]
    right = np.clip(right.astype(np.int64) + rng.integers(-noise, noise, right.shape),
                    1, 255).astype(np.uint8)
    right[:, :2] = 0
    left = np.pad(left, ((0, 0), (0, wl_extra), (0, 0)))
    return left, right


def perceptual_volume(rng, h, d, w, ties=False, specials=False):
    """An (h, d, w) float32 cost volume that drives every branch of the
    windowed smoother (K4): costs in [1, 1.25] (so the weights, 0.85-1.85,
    flip winners), +inf past each pixel's min(d, w - x) candidates as in a
    real volume, a few more +inf entries and all-+inf pixels, and the last
    valid candidate made cheap near the right edge, so a pixel's left
    neighbour picks an index equal to its own candidate count (the clamp
    ``mean == size``). ``ties`` rounds the costs to 1/8. ``specials`` then
    seeds NaN (~0.3 a pixel) and +0.0 and -0.0 (~0.5 a pixel each) among
    the finite costs: a NaN wins its pixel, and +0.0 ties -0.0, the smaller
    index winning."""
    cost = rng.uniform(1.0, 1.25, (h, d, w)).astype(np.float32)
    if ties:
        cost = np.round(cost * 8) / 8
    cost[rng.uniform(size=cost.shape) < 0.05] = np.inf
    cost[:, :, rng.uniform(size=w) < 0.02] = np.inf
    sizes = np.minimum(d, w - np.arange(w))
    edge = np.arange(w) >= w - d
    cost[:, sizes[edge] - 1, np.flatnonzero(edge)] = 0.5
    cost[:, np.arange(d)[:, None] >= sizes[None, :]] = np.inf
    if specials:
        u = np.where(np.isfinite(cost), rng.uniform(size=cost.shape) * d, np.inf)
        cost[u < 0.3] = np.nan
        cost[(u >= 0.3) & (u < 0.8)] = 0.0
        cost[(u >= 0.8) & (u < 1.3)] = -0.0
    return cost


def narrow_vgg_params(seed=3, widths=(4, 8, 8, 8, 8)):
    """He-init VGG-16 weights with the given stage widths, in the JAX
    package's layout, with their own non-uniform ``lins``: the perceptual
    matcher's tests run the tower at these widths (full widths are slow on
    a CPU)."""
    rng = np.random.default_rng(seed)
    params = {"convs": [], "lins": []}
    in_ch = 3
    for width, n_convs in zip(widths, (2, 2, 3, 3, 3)):
        block = []
        for _ in range(n_convs):
            w = rng.normal(0, np.sqrt(2.0 / (9 * in_ch)), (width, in_ch, 3, 3))
            block.append((w.astype(np.float32), np.zeros(width, np.float32)))
            in_ch = width
        params["convs"].append(block)
        params["lins"].append((rng.uniform(0.5, 1.5, width) / width).astype(np.float32))
    return params


def perceptual_pair(rng, h, w, shift=4, noise=4.0):
    """Random texture; the right image is the left shifted by ``shift``
    columns (wrapping at the right edge) plus Gaussian noise, float32 in
    [0, 255] (tests/test_perceptual.py's oracle pair)."""
    left = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
    right = np.roll(left, -shift, axis=1) + rng.normal(0, noise, (h, w, 3)).astype(np.float32)
    return left, np.clip(right, 0, 255).astype(np.float32)


def _median_ms(fn, torch, calls=1):
    """Median over REPEATS of the CUDA-event time of ``calls`` back-to-back
    calls, divided by ``calls``, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return statistics.median(times)


def _median_queued_ms(fn, torch, calls=CALLS, sleep_cycles=100_000_000):
    """``_median_ms`` with the calls queued behind a sleeping kernel (~50 ms
    at the H100's clock), so the events time the device's back-to-back
    work and not the host's enqueue of launches shorter than their
    dispatch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return statistics.median(times)


def ransac_times(torch, ml, mr, K, nv, u, cfg):
    """(kernel ms, ms of its twin replayed from a CUDA graph, as the pose
    stage replayed it before the kernel) of RANSAC on one pair's card
    tensors: (3, N) matches, (3, 3) intrinsics, a 0-d valid count and
    (num_hypotheses, N) draws; each queued (``_median_queued_ms``). Its own
    calls are counted in ``LAUNCHES["ransac"]``."""
    from stereo_reconstruction_tpu_torch.ops import cuda_ransac
    from stereo_reconstruction_tpu_torch.pose.ransac import ransac_plain

    dev, n = ml.device, ml.shape[-1]
    args = (ml[None], mr[None], K[None], K[None], nv.reshape(1), u[None])
    out = cuda_ransac.result_buffers((1,), cuda_ransac.support_of(cfg, n), dev)
    scratch = cuda_ransac.scratch_buffers(1, cfg, n, dev)
    kernel_ms = _median_queued_ms(lambda: cuda_ransac.ransac(*args, cfg, out, scratch), torch)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        ransac_plain(ml, mr, K, K, cfg, nv, u)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ransac_plain(ml, mr, K, K, cfg, nv, u)
    return kernel_ms, _median_queued_ms(graph.replay, torch, calls=2)


def request_matches(name, n):
    """A benchmark request's valid matches saved under ``tests/data/<name>.npz``
    (``posed_request_matches``: 222 at 750x900; ``far_winner_request``: 241)
    as (3, n) homogeneous matches padded with seeded pixels: (left, right,
    n_valid)."""
    import torch

    d = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                             f"{name}.npz"))
    rng = np.random.default_rng(SEED)
    nv = len(d["left"])
    sides = []
    for side in ("left", "right"):
        xy = rng.uniform(0, 900, (n, 2)).astype(np.float32)
        xy[:nv] = d[side]
        sides.append(torch.from_numpy(np.concatenate([xy.T, np.ones((1, n), np.float32)])))
    return sides[0], sides[1], nv


def _max_abs_err(got, want):
    """Largest |got - want| over the entries where want is finite."""
    fin = want.isfinite()
    if not fin.any():
        return 0.0
    return float((got[fin].double() - want[fin].double()).abs().max())


def _sequential_reference(left, right, block_size, max_d, sf=0.9):
    """Literal NumPy Right-variant matcher (BlockSearch.cpp:88-179) on
    integer images: exact int64 window sums, the float32 cost transform,
    and the row-major smoothing recurrence."""
    h, w = right.shape[:2]
    w_l = left.shape[1]
    hbs = (block_size - 1) // 2
    L = np.pad(left.astype(np.int64), ((0, 0), (0, w + max_d), (0, 0)))
    R = right.astype(np.int64)
    cost = np.full((max_d, h, w), np.inf, np.float32)
    for d in range(max_d):
        dsq = ((L[:, d:d + w] - R) ** 2).sum(-1)
        dsq[h - 1, :] = 0
        dsq[:, w - 1] = 0
        c = np.zeros((h + 1, w + 1), np.int64)
        c[1:, 1:] = dsq.cumsum(0).cumsum(1)
        for y in range(h):
            y0, y1 = max(0, y - hbs), min(h, y + hbs)
            for x in range(w):
                x0, x1 = max(0, x - hbs), min(w, x + hbs)
                rgt = min(w - 1 - x, hbs)
                area = (min(x, hbs) + rgt) * (min(y, hbs) + min(h - 1 - y, hbs))
                if area <= 0 or x + d + rgt >= w_l:
                    continue
                ssd = c[y1, x1] - c[y0, x1] - c[y1, x0] + c[y0, x0]
                inv = np.float32(1.0) / np.float32(area)
                cost[d, y, x] = np.sqrt(np.float32(ssd)) * inv
    black = (right == 0).all(-1)
    sf = np.float32(sf)
    dvals = np.arange(max_d, dtype=np.float32)
    disp = np.zeros((h, w), np.float32)
    for y in range(h):
        for x in range(w):
            if black[y, x]:
                continue
            c = cost[:, y, x].copy()
            if y >= 1:
                c[dvals == -disp[y - 1, x]] *= sf
            if x >= 1:
                c[dvals == -disp[y, x - 1]] *= sf
            i = int(np.argmin(c))
            disp[y, x] = dvals[i] if np.isfinite(c[i]) else -np.float32(x)
    return disp


def _rodrigues(v):
    theta = np.linalg.norm(v)
    k = v / theta
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * Kx + (1 - np.cos(theta)) * Kx @ Kx


def _synthetic_scene(rng, h=750, w=900):
    """A textured plane at depth 14 seen by two cameras (K, a small R, unit
    T): the right image is the plane-induced homography warp of the left;
    F = K^-T [T]x R K^-1."""
    K, R, T = _camera_pair(h, w)
    Tx = np.array([[0, -T[2], T[1]], [T[2], 0, -T[0]], [-T[1], T[0], 0]])
    Kinv = np.linalg.inv(K)
    F = Kinv.T @ Tx @ R @ Kinv
    F /= np.linalg.norm(F)
    n, depth = np.array([0.0, 0.0, 1.0]), 14.0
    H_lr = K @ (R + np.outer(T, n) / depth) @ Kinv
    tex = rng.integers(10, 250, (h // 3 + 1, w // 3 + 1, 3)).astype(np.float64)
    for _ in range(2):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1) + np.roll(tex, -1, 0)) / 4
    left = np.repeat(np.repeat(tex, 3, 0), 3, 1)[:h, :w]
    left = np.clip(left + rng.integers(-20, 20, left.shape), 0, 255).astype(np.uint8)
    return left, H_lr, F, K


def _camera_pair(h, w):
    """The smoke scenes' cameras: K with focal w, a small R, unit T."""
    K = np.array([[float(w), 0, w / 2], [0, float(w), h / 2], [0, 0, 1]])
    R = _rodrigues(np.array([0.02, -0.08, 0.01]))
    T = np.array([-1.0, 0.05, 0.15])
    return K, R, T / np.linalg.norm(T)


def nonplanar_scene(rng, h=750, w=900):
    """The smoke cameras over the smooth surface Z = 10 + 8 (0.5 + 0.5
    sin(6x/w) cos(4y/h)) of the left pixel (x, y), textured with Gaussian
    blobs; the eight-point solve is degenerate on a plane, not here.

    The texture is rendered at 4 samples per pixel and axis. The left image
    takes it at pixel centres; each right pixel takes it, bilinearly, at
    the left point it sees, found by fixed-point iteration through the
    surface (the disparity changes slowly, so the map contracts). Each image
    gets its own sensor noise; right pixels that see no left point stay
    black. Returns (left, right, K, R, T, F, src): F = K^-T [T]x R K^-1 at
    unit norm, and src (2, h, w) the left coordinates each right pixel
    sees (NaN where none)."""
    K, R, T = _camera_pair(h, w)
    Tx = np.array([[0, -T[2], T[1]], [T[2], 0, -T[0]], [-T[1], T[0], 0]])
    Kinv = np.linalg.inv(K)
    F = Kinv.T @ Tx @ R @ Kinv
    F /= np.linalg.norm(F)

    ss = 4
    tex = np.full((h * ss, w * ss), 128.0)
    n_blobs = h * w // 80
    cy, cx = rng.uniform(0, h, n_blobs), rng.uniform(0, w, n_blobs)
    amp = rng.uniform(40, 120, n_blobs) * rng.choice([-1.0, 1.0], n_blobs)
    sig = rng.uniform(1.0, 3.0, n_blobs)
    for y, x, a, s in zip(cy, cx, amp, sig):
        r = 4 * s
        y0, y1 = max(0, int((y - r) * ss)), min(h * ss, int((y + r) * ss) + 1)
        x0, x1 = max(0, int((x - r) * ss)), min(w * ss, int((x + r) * ss) + 1)
        yy = np.arange(y0, y1)[:, None] / ss - y
        xx = np.arange(x0, x1)[None, :] / ss - x
        tex[y0:y1, x0:x1] += a * np.exp(-(yy * yy + xx * xx) / (2 * s * s))

    def sensor(img):
        img = np.clip(img + rng.normal(0, 2, img.shape), 0, 255)
        return np.repeat(np.round(img)[..., None], 3, axis=2).astype(np.uint8)

    def depth(x, y):
        return 10 + 8 * (0.5 + 0.5 * np.sin(6 * x / w) * np.cos(4 * y / h))

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    px, py = xs.copy(), ys.copy()
    for _ in range(40):
        X = depth(px, py).ravel() * (Kinv @ np.stack([px.ravel(), py.ravel(), np.ones(h * w)]))
        pr = K @ (R @ X + T[:, None])
        px = px - (pr[0] / pr[2]).reshape(h, w) + xs
        py = py - (pr[1] / pr[2]).reshape(h, w) + ys
    seen = (px >= 0) & (px <= w - 1) & (py >= 0) & (py <= h - 1)
    sx, sy = np.where(seen, px, 0) * ss, np.where(seen, py, 0) * ss
    x0 = np.minimum(np.floor(sx).astype(np.int64), w * ss - 2)
    y0 = np.minimum(np.floor(sy).astype(np.int64), h * ss - 2)
    fx, fy = sx - x0, sy - y0
    right = ((tex[y0, x0] * (1 - fx) + tex[y0, x0 + 1] * fx) * (1 - fy)
             + (tex[y0 + 1, x0] * (1 - fx) + tex[y0 + 1, x0 + 1] * fx) * fy)
    right = np.where(seen[..., None], sensor(right), 0).astype(np.uint8)
    src = np.where(seen, np.stack([px, py]), np.nan)
    return sensor(tex[::ss, ::ss]), right, K, R, T, F, src


def nonplanar_disparity(src, F):
    """Ground truth for the right image of ``nonplanar_scene`` in its
    original frame: the rectified-frame disparity x_l - x_r between each
    right pixel and the left point it shows, under F's Loop-Zhang
    homographies, and the mask (255) of the pixels that show one."""
    from stereo_reconstruction_tpu_torch.rectify.loop_zhang import loop_zhang_homographies

    h, w = src.shape[1:]
    homs = loop_zhang_homographies(F, (h, w), (h, w))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    shown = np.isfinite(src[0])
    p = np.stack([np.where(shown, src[0], 0).ravel(), np.where(shown, src[1], 0).ravel(),
                  np.ones(h * w)])
    q = np.stack([xs.ravel(), ys.ravel(), np.ones(h * w)])
    pl = homs.H_left @ p
    pr = homs.H_right @ q
    gt = (pl[0] / pl[2] - pr[0] / pr[2]).reshape(h, w)
    return (np.where(shown, gt, np.inf).astype(np.float32),
            np.where(shown, 255, 0).astype(np.uint8))


def pose_angles(pose, R, T):
    """(rotation angle, translation-direction angle) in degrees between a
    4x4 pose and the rotation R and translation T of another."""
    pose = np.asarray(pose, np.float64)
    cos_r = (np.trace(pose[:3, :3] @ np.asarray(R, np.float64).T) - 1) / 2
    t = pose[:3, 3] / np.linalg.norm(pose[:3, 3])
    cos_t = t @ (np.asarray(T, np.float64) / np.linalg.norm(T))
    return tuple(float(a) for a in np.degrees(np.arccos(np.clip([cos_r, cos_t], -1, 1))))


def write_png(path, img):
    """A uint8 (H, W) or (H, W, 3) array as an 8-bit grayscale or RGB PNG,
    with the standard library alone (zlib, struct): PIL may be absent."""
    import struct
    import zlib

    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             2 if img.ndim == 3 else 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_middeval_scene(root, name, left, right, K, ndisp, split="trainingH",
                         gt=None, mask=None, gt_left=None, mask_left=None):
    """One MiddEval3 scenario directory ``<root>/<split>/<name>/``: im0.png,
    im1.png, calib.txt (cam0 = cam1 = K, baseline 1), and where given
    disp1GT.pfm, mask1nocc.png, disp0GT.pfm and mask0nocc.png."""
    from stereo_reconstruction_tpu_torch.io.pfm import write_pfm

    d = os.path.join(root, split, name)
    os.makedirs(d, exist_ok=True)
    write_png(os.path.join(d, "im0.png"), left)
    write_png(os.path.join(d, "im1.png"), right)
    cam = "[" + "; ".join(" ".join(repr(float(v)) for v in row)
                          for row in np.asarray(K, np.float64)) + "]"
    with open(os.path.join(d, "calib.txt"), "w") as f:
        f.write(f"cam0={cam}\ncam1={cam}\ndoffs=0\nbaseline=1.0\n"
                f"width={right.shape[1]}\nheight={right.shape[0]}\nndisp={ndisp}\n"
                f"isint=0\nvmin=0\nvmax={ndisp}\ndyavg=0\ndymax=0\n")
    for fname, arr in (("disp1GT.pfm", gt), ("disp0GT.pfm", gt_left)):
        if arr is not None:
            write_pfm(os.path.join(d, fname), np.asarray(arr, np.float32))
    for fname, arr in (("mask1nocc.png", mask), ("mask0nocc.png", mask_left)):
        if arr is not None:
            write_png(os.path.join(d, fname), arr)
    return d


def flat_pair(h=64, w=96, shift=5, seed=0):
    """A pair whose rows are all equal (no keypoint passes the Hessian
    test, so the pose is invalid), the right view shifted by ``shift``."""
    row = np.random.default_rng(seed).integers(10, 250, (1, w + 14, 3)).astype(np.uint8)
    return np.repeat(row[:, :w], h, axis=0), np.repeat(row[:, shift:w + shift], h, axis=0)


def _device_events(prof):
    """[(name, count, device us)] of the device work one profile saw, read
    from the raw Kineto events: ``key_averages()`` would first build the
    tree of every host op, ~1 min for the pose stage's 60k launches and
    ~2 min for a mesh batch's 120k."""
    from torch.autograd import DeviceType

    return [(e.name(), 1, e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _pose_profile(estimate, torch):
    """(device kernels launched, device ms, wall ms) of one call, from
    torch.profiler; None for the device numbers if it saw no device work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        estimate()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    kernels = sum(n for _, n, _ in events)
    if kernels == 0:
        return None, None, wall_ms
    return kernels, sum(us for _, _, us in events) / 1e3, wall_ms


def _kernel_split(call, torch):
    """Device ms of one call by kernel name (torch.profiler), {} if the
    profiler saw no device work."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    split = {}
    for key, _, us in _device_events(prof):
        name = next((k for k in ("left_layout_kernel", "block_search_costs_kernel",
                                 "block_search_rows_kernel") if k in key), key[:40])
        split[name] = split.get(name, 0.0) + us / 1e3
    return split


KERNEL_NAMES = {"K1": "matcher_inputs_kernel", "K1b": "row_scan_kernel",
                "K2": "cost_volume_kernel", "K3": "block_search_rows_kernel",
                "K4": "perceptual_scan_kernel", "warp": "warp_kernel",
                "ransac": "stpu::ransac::"}


def _profiled_launches(call, torch):
    """(launches of each kernel of KERNEL_NAMES, device kernels in all,
    device ms) of one call, as torch.profiler sees them; None for the
    launches if it saw no device work."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    seen, kernels, device_us = dict.fromkeys(KERNEL_NAMES, 0), 0, 0.0
    for key, n, us in _device_events(prof):
        kernels += n
        device_us += us
        for k, name in KERNEL_NAMES.items():
            if name in key:
                seen[k] += n
    return (seen if kernels else None), kernels, device_us / 1e3


def _true_disparity(H_lr, F, h, w):
    """Ground truth for the right image in its original frame: the
    rectified-frame disparity x_l - x_r of each right pixel's true match,
    and the mask (255) of right pixels whose match lies in the left image."""
    from stereo_reconstruction_tpu_torch.rectify.loop_zhang import loop_zhang_homographies

    homs = loop_zhang_homographies(F, (h, w), (h, w))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    q = np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)])
    p = np.linalg.solve(H_lr, q)
    p /= p[2]
    pl = homs.H_left @ p
    pr = homs.H_right @ q
    gt = (pl[0] / pl[2] - pr[0] / pr[2]).reshape(h, w).astype(np.float32)
    inside = (p[0] >= 0) & (p[0] <= w - 1) & (p[1] >= 0) & (p[1] <= h - 1)
    return gt, np.where(inside.reshape(h, w), 255, 0).astype(np.uint8)


def _same_batch_result(got, want, what):
    """Two BatchResults equal field by field, bit for bit."""
    for name in ("disparity", "depth", "pose_ok"):
        g, w = getattr(got, name), getattr(want, name)
        if (g is None) != (w is None) or (g is not None and not np.array_equal(g, w)):
            raise AssertionError(f"{what}: {name} differs")
    if got.metrics != want.metrics:
        raise AssertionError(f"{what}: metrics differ")
    for name, g, w in zip(got.pose._fields, got.pose, want.pose):
        a, b = g.cpu().numpy(), w.cpu().numpy()
        same = np.array_equal(a, b) or (a.dtype.kind == "f"
                                         and np.array_equal(a, b, equal_nan=True))
        if g.device != w.device or not same:
            raise AssertionError(f"{what}: pose field {name} differs")


def batch_phase(torch, dev, config, smi, counts, reset_counts, expected, h=750, w=900):
    """Phase 10: ``run_batch`` on three posed pairs and one whose pose
    fails, (h, w), at ``config``, unsharded and on a data=2 mesh over
    ``dev`` x 2, and ``run_batches`` on that mesh; returns the pairs and the
    K1/K1b launch counts of the checked run."""
    from stereo_reconstruction_tpu_torch.data.records import StereoPair, pad_to
    from stereo_reconstruction_tpu_torch.parallel import make_mesh
    from stereo_reconstruction_tpu_torch.pipeline_batch import (
        batch_uniforms,
        run_batch,
        run_batches,
    )

    t_phase = time.perf_counter()
    pairs = []
    for seed in range(3):
        left_np, right_np, K, _, _, F_true, src = nonplanar_scene(
            np.random.default_rng(seed), h, w)
        gt, mask = nonplanar_disparity(src, F_true)
        pairs.append(StereoPair(left_np, right_np, K.astype(np.float32),
                                K.astype(np.float32), disp_right_gt=gt,
                                mask_right_nocc=mask, name=f"nonplanar{seed}"))
    fl, fr = flat_pair()
    K_flat = np.array([[96.0, 0, 48], [0, 96, 32], [0, 0, 1]], np.float32)
    pairs.append(pad_to(StereoPair(fl, fr, K_flat, K_flat, name="flat"), h, w))
    B = len(pairs)
    u = batch_uniforms(config, B)
    reset_counts()
    res = run_batch(pairs, config, uniforms=u, device=dev)
    if counts() != expected(K1=B, K1b=B, warp=2, ransac=2):
        raise AssertionError(f"run_batch launches {counts()}: want {B} K1, {B} K1b and 2 "
                             f"warps (the {2 * B} rectifying images, the back-warps)")
    launches = {"K1": counts()["K1"], "K1b": counts()["K1b"]}
    padded = (B, h + (-h) % 8, w + (-w) % 128)
    if res.disparity.shape != padded or not np.isfinite(res.disparity).all():
        raise AssertionError(f"run_batch: bad disparity {res.disparity.shape}")
    if res.pose_ok.tolist() != [True, True, True, False]:
        raise AssertionError(f"run_batch pose_ok {res.pose_ok.tolist()}, want 1, 1, 1, 0")
    if not (np.array_equal(res.disparity, np.rint(res.disparity))
            and np.abs(res.disparity).max() < 2**15):
        raise AssertionError("run_batch disparities are not int16-exact")
    for i in range(3):
        m = res.metrics[i]
        print(f"[batch] pair {i}: evaldisp vs the true disparity: bad-2.0 "
              f"{m['bad_percent']:.3f}%, invalid {m['invalid_percent']:.3f}%, "
              f"BA {m['reproj_error_ba']:.4f} px", flush=True)
        if not m["bad_percent"] < MAX_TOTAL_BAD:
            raise AssertionError(f"run_batch pair {i}: {m}")
    reset_counts()
    plain = run_batch(pairs, config.replace(matcher=dataclasses.replace(config.matcher,
                                                                        backend="xla")),
                      uniforms=u, device=dev)
    if counts() != expected(warp=2, ransac=2):
        raise AssertionError(f"plain run_batch launched matcher kernels: {counts()}")
    agree_plain = [float(np.mean(res.disparity[i] == plain.disparity[i])) for i in range(B)]
    agree_one = [float(np.mean(res.disparity[i] == run_batch(
        [pairs[i]], config, uniforms=u[i:i + 1], device=dev).disparity[0]))
        for i in range(3)]
    unmasked = run_batch(pairs[:3], config, uniforms=u[:3], device=dev)
    agree_unmasked = [float(np.mean(res.disparity[i] == unmasked.disparity[i]))
                      for i in range(3)]
    print(f"[batch] run_batch B={B} {h}x{w} D={config.matcher.max_disparity}: pose_ok {res.pose_ok.astype(int).tolist()}, "
          f"{B} K1 and {B} K1b launches, int16-exact; disparity agreement with the "
          f"plain backend {[round(a, 6) for a in agree_plain]}, each good pair with "
          f"itself at B=1 {[round(a, 6) for a in agree_one]}, with the batch without "
          f"the degenerate pair {[round(a, 6) for a in agree_unmasked]}", flush=True)
    if min(agree_plain + agree_one + agree_unmasked) < 0.995:
        raise AssertionError("run_batch disparity agreement below 99.5%")
    seen, n_kernels, device_ms = _profiled_launches(
        lambda: run_batch(pairs, config, uniforms=u, device=dev), torch)
    if seen is None:
        raise AssertionError("the profiler saw no device work in run_batch")
    if seen != expected(K1=B, K1b=B, warp=2, ransac=2):
        raise AssertionError(f"the profiler saw {seen} in run_batch: want {B} K1, "
                             f"{B} K1b and 2 warps")
    print(f"[batch] torch.profiler in run_batch B={B}: {seen}; {n_kernels} device "
          f"kernels in all, {device_ms:.1f} ms device time", flush=True)

    # the batch over a mesh's data axis: two shards of two pairs, both on dev
    mesh = make_mesh(data=2, tile=1, devices=[dev, dev])
    reset_counts()
    sharded = run_batch(pairs, config, uniforms=u, mesh=mesh)
    if counts() != expected(K1=B, K1b=B, warp=4, ransac=4):
        raise AssertionError(f"run_batch(mesh=) launches {counts()}: want {B} K1, {B} K1b "
                             f"and 2 warps a shard")
    if sharded.disparity.shape != padded or not np.isfinite(sharded.disparity).all():
        raise AssertionError(f"run_batch(mesh=): bad disparity {sharded.disparity.shape}")
    if sharded.pose_ok.tolist() != [True, True, True, False]:
        raise AssertionError(f"run_batch(mesh=) pose_ok {sharded.pose_ok.tolist()}")
    if not (np.array_equal(sharded.disparity, np.rint(sharded.disparity))
            and np.abs(sharded.disparity).max() < 2**15):
        raise AssertionError("run_batch(mesh=) disparities are not int16-exact")
    if set(sharded.timings) != set(res.timings):
        raise AssertionError(f"run_batch(mesh=) timings {sorted(sharded.timings)}")
    half = B // 2
    for i in range(2):
        rows = slice(i * half, (i + 1) * half)
        alone = run_batch(pairs[rows], config, uniforms=u[rows], device=dev)
        part = dataclasses.replace(
            sharded, disparity=sharded.disparity[rows], depth=sharded.depth[rows],
            pose_ok=sharded.pose_ok[rows], metrics=sharded.metrics[rows],
            pose=type(sharded.pose)(*(f[rows] for f in sharded.pose)))
        _same_batch_result(part, alone, f"run_batch(mesh=) shard {i} vs its pairs alone")
    agree_mesh = [float(np.mean(sharded.disparity[i] == res.disparity[i])) for i in range(B)]
    print(f"[batch] run_batch B={B} on a data=2, tile=1 mesh over {dev} x 2: pose_ok "
          f"{sharded.pose_ok.astype(int).tolist()}, {B} K1 and {B} K1b launches, int16-exact; "
          f"each shard bit-equal to its {half} pairs run alone with their draws; disparity "
          f"agreement with the unsharded B={B} {[round(a, 6) for a in agree_mesh]}", flush=True)
    if min(agree_mesh) < 0.995:
        raise AssertionError("run_batch(mesh=) agreement with the unsharded run below 99.5%")
    seen, n_kernels, device_ms = _profiled_launches(
        lambda: run_batch(pairs, config, uniforms=u, mesh=mesh), torch)
    if seen is None:
        raise AssertionError("the profiler saw no device work in run_batch(mesh=)")
    if seen != expected(K1=B, K1b=B, warp=4, ransac=4):
        raise AssertionError(f"the profiler saw {seen} in run_batch(mesh=): want {B} K1, "
                             f"{B} K1b and 4 warps")
    print(f"[batch] torch.profiler in run_batch(mesh=) B={B}: {seen}; {n_kernels} device "
          f"kernels in all, {device_ms:.1f} ms device time", flush=True)
    reset_counts()
    piped = run_batches([pairs, pairs], config, mesh=mesh)
    if counts() != expected(K1=2 * B, K1b=2 * B, warp=8, ransac=8):
        raise AssertionError(f"run_batches(mesh=) launches {counts()}: want {2 * B} K1 and "
                             f"K1b, 8 warps")
    _same_batch_result(piped[0], sharded, "run_batches(mesh=) batch 0 vs run_batch(mesh=)")
    _same_batch_result(piped[1], run_batch(pairs, config, uniforms=batch_uniforms(config, B, 1),
                                           mesh=mesh),
                       "run_batches(mesh=) batch 1 vs run_batch(mesh=)")
    print(f"[batch] run_batches(mesh=) on two batches of {B}: {2 * B} K1 and {2 * B} K1b "
          f"launches, each batch bit-equal to run_batch(mesh=) with its draws; batch 1 "
          f"pose_ok {piped[1].pose_ok.astype(int).tolist()}", flush=True)

    # stage ms: B=1, then B=4 unsharded and on the mesh in turn
    runs = {"B=1": [], f"B={B}": [], f"B={B} on the mesh": []}
    calls = [("B=1", pairs[:1], None)] * 4 + [(f"B={B}", pairs, None),
                                              (f"B={B} on the mesh", pairs, mesh)] * 4
    for key, ps, m in calls:
        t0 = time.perf_counter()
        r = run_batch(ps, config, uniforms=u[:len(ps)], mesh=m, device=dev)
        runs[key].append(dict(r.timings, wall=time.perf_counter() - t0, pairs=len(ps)))
    for key, rs in runs.items():
        rs = rs[1:]                        # the first run of each is the warm-up
        med = {k: statistics.median(t[k] for t in rs) * 1e3 for k in rs[0] if k != "pairs"}
        print(f"[batch] {smi}: run_batch {key} stage ms (median of 3 after a warm-up): "
              + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
              + f"; {rs[0]['pairs'] / (med['wall'] / 1e3):.3f} pairs/s", flush=True)
    print(f"[batch] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return pairs, launches


def cli_phase(torch, dev, config, p0, device_args=()):
    """Phase 11: the command line on a MiddEval3-shaped tree of ``p0``'s
    scene, each subcommand a subprocess (``device_args`` are passed to
    each; the card by default)."""
    import importlib.util

    from stereo_reconstruction_tpu_torch.data import MiddEval3
    from stereo_reconstruction_tpu_torch.io import native
    from stereo_reconstruction_tpu_torch.io.pfm import read_pfm
    from stereo_reconstruction_tpu_torch.ops.metrics import evaldisp
    from stereo_reconstruction_tpu_torch.pipeline import run_pair

    print(f"[cli] PNG readers: native decoder "
          f"{'built' if native.available() else 'unavailable: ' + str(native.build_error())}"
          f", PIL {'present' if importlib.util.find_spec('PIL') else 'absent'}", flush=True)
    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))

    def cli(*args):
        out = subprocess.run([sys.executable, "-m", "stereo_reconstruction_tpu_torch", *args,
                              *device_args], cwd=repo, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"cli {args[0]} exited {out.returncode}:\n{out.stderr}")
        return [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]

    with tempfile.TemporaryDirectory() as tmp:
        root, out_dir = os.path.join(tmp, "MiddEval3"), os.path.join(tmp, "out")
        scene = write_middeval_scene(root, "Nonplanar", p0.image_left, p0.image_right,
                                     p0.intrinsics_left, ndisp=200, gt=p0.disp_right_gt,
                                     mask=p0.mask_right_nocc)
        t0 = time.perf_counter()
        run_line = cli("run", "--data", root, "--scenario", "0", "--out", out_dir)
        batch_lines = cli("run", "--batch", "--data", root, "--scenario", "0", "0")
        staged = os.path.join(out_dir, "Nonplanar_disp.pfm")
        eval_line = cli("eval", "--disp", staged, "--gt", os.path.join(scene, "disp1GT.pfm"),
                        "--mask", os.path.join(scene, "mask1nocc.png"))
        cli_s = time.perf_counter() - t0
        loaded = MiddEval3(root).load_training(0)
        if not (np.array_equal(loaded.image_left, p0.image_left)
                and np.array_equal(loaded.mask_right_nocc, p0.mask_right_nocc)):
            raise AssertionError("the tree does not load back equal")
        want = run_pair(loaded, config, device=dev)
        disp = read_pfm(staged)
        agree = float(np.mean(disp == want.disparity))
        if len(run_line) != 1 or run_line[0]["metrics"]["pose_ok"] != 1.0 or agree < 0.995:
            raise AssertionError(f"cli run: {run_line}, agreement {agree} with run_pair")
        if len(batch_lines) != 2 or any(x["pose_ok"] != 1.0
                                        or not x["bad_percent"] < MAX_TOTAL_BAD
                                        for x in batch_lines):
            raise AssertionError(f"cli run --batch: {batch_lines}")
        m = {k: float(v) for k, v in evaldisp(
            torch.from_numpy(disp).to(dev),
            torch.from_numpy(loaded.disp_right_gt).to(dev),
            torch.from_numpy(loaded.mask_right_nocc).to(dev), bad_thresh=2.0,
            max_disp=1e9).items()}
        if (len(eval_line) != 1 or eval_line[0].keys() != m.keys()
                or any(abs(eval_line[0][k] - v) > 1e-5 * max(1.0, abs(v))
                       for k, v in m.items())):
            raise AssertionError(f"cli eval {eval_line} != in-process evaldisp {m}")
    print(f"[cli] run, run --batch and eval as subprocesses on a MiddEval3 tree "
          f"({cli_s:.1f} s): run's staged disparity agrees {agree:.6f} with run_pair of "
          f"the loaded pair; run --batch pose_ok 1, 1, bad-2.0 "
          f"{[round(x['bad_percent'], 3) for x in batch_lines]}; eval equals evaldisp "
          f"(bad-2.0 {eval_line[0]['bad_percent']:.3f}%); phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def _wall_ms(fn, torch, repeats=3):
    """Median host-clock ms of ``repeats`` calls that end in a synchronize,
    after a warm-up call; returns (ms, the warm-up call's result)."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def variants_phase(torch, dev, smi, rect, pair, F, batch_pair, counts, reset_counts,
                   expected):
    """Phase 12: the dense variants on the slice's rectified canvas
    ``rect`` (of ``pair``, with fundamental matrix ``F``)."""
    from stereo_reconstruction_tpu_torch.config import MatcherConfig, PipelineConfig
    from stereo_reconstruction_tpu_torch.ops import block_search as bs
    from stereo_reconstruction_tpu_torch.ops import cost_volume as cv
    from stereo_reconstruction_tpu_torch.ops import cuda_row_scan as crs
    from stereo_reconstruction_tpu_torch.ops import smoothing
    from stereo_reconstruction_tpu_torch.ops.linear_search import linear_search
    from stereo_reconstruction_tpu_torch.pipeline import run_pair
    from stereo_reconstruction_tpu_torch.pipeline_batch import batch_uniforms, run_batch

    t_phase = time.perf_counter()
    L, R = rect.left, rect.right
    black = cv.black_pixel_mask(R)
    volumes = {
        "sad": (dict(cost="sad"), lambda: cv.cost_volume_right_sad(L, R, 17, 0, 200)),
        "ncc": (dict(cost="ncc"), lambda: cv.cost_volume_right_ncc(L, R, 17, 0, 200)),
        "var_block": (dict(var_block=True),
                      lambda: bs._varblock_cost(L, R, MatcherConfig(var_block=True))),
    }
    for name, (kw, volume) in volumes.items():
        cfg = MatcherConfig(**kw)
        reset_counts()
        disp = bs.block_search_right(L, R, cfg)
        torch.cuda.synchronize()
        if counts() != expected(K1b=1):
            raise AssertionError(f"[variants] {name}: launches {counts()}, want one K1b")
        if disp.shape != tuple(rect.canvas) or not torch.isfinite(disp).all():
            raise AssertionError(f"[variants] {name}: bad disparity {tuple(disp.shape)}")
        planes = smoothing.volume_reductions(volume(), 0)
        scan = dict(smooth_factor=0.9, d_first=0, n_planes=200)
        got = crs.row_scan(*planes, black, **scan)
        plain = smoothing.smoothed_argmin_from_inputs(*planes, black, **scan)
        agree = float((got == plain).double().mean())
        if not (torch.equal(got, plain) and torch.equal(got, disp)):
            raise AssertionError(f"[variants] {name}: K1b vs the plain scan {agree:.6f}")
        del planes
        route_ms, _ = _wall_ms(lambda: bs.block_search_right(L, R, cfg), torch)
        print(f"[variants] {name} {tuple(rect.canvas)} D=200: 1 K1b launch; K1b agrees "
              f"{agree:.6f} with the plain scan on the volume's planes; "
              f"block_search_right {route_ms:.2f} ms (median of 3, {smi})", flush=True)

    base = PipelineConfig()
    for cost in ("sad", "ncc"):
        config = base.replace(matcher=MatcherConfig(cost=cost))
        reset_counts()
        res = run_pair(pair, config, fixed_F=F, device=dev)
        if counts() != expected(K1b=1, warp=2):
            raise AssertionError(f"[variants] run_pair {cost}: launches {counts()}")
        m = res.metrics
        print(f"[variants] run_pair(fixed_F=F) {cost} 750x900: evaldisp vs the true "
              f"disparity bad-2.0 {m['bad_percent']:.3f}%, invalid "
              f"{m['invalid_percent']:.3f}%, stage ms " + ", ".join(
                  f"{k} {v * 1e3:.2f}" for k, v in res.timings.items()), flush=True)
        if not m["bad_percent"] < MAX_TOTAL_BAD:
            raise AssertionError(f"[variants] run_pair {cost}: {m}")
    config = base.replace(matcher=MatcherConfig(cost="ncc"))
    reset_counts()
    res = run_batch([batch_pair], config, uniforms=batch_uniforms(config, 1), device=dev)
    if counts() != expected(K1b=1, warp=2, ransac=2) or not res.pose_ok[0]:
        raise AssertionError(f"[variants] run_batch ncc: launches {counts()}, "
                             f"{res.metrics}")
    if not res.metrics[0]["bad_percent"] < MAX_TOTAL_BAD:
        raise AssertionError(f"[variants] run_batch ncc: {res.metrics}")
    print(f"[variants] run_batch ncc B=1: pose_ok, 1 K1b launch, bad-2.0 "
          f"{res.metrics[0]['bad_percent']:.3f}%", flush=True)

    # the Left variant (the fixpoint smoother, no kernel) and the linear
    # search (the exact recurrence: K1b)
    y0, x0 = (rect.canvas[0] - 240) // 2, (rect.canvas[1] - 320) // 2
    crop = (slice(y0, y0 + 240), slice(x0, x0 + 320))
    cfg = MatcherConfig()
    for name, fn, launches in (
            ("block_search_left", lambda l, r: bs.block_search_left(l, r, cfg), {}),
            ("linear_search", lambda l, r: linear_search(l, r), dict(K1b=1))):
        reset_counts()
        got = fn(L[crop].contiguous(), R[crop].contiguous())
        if counts() != expected(**launches):
            raise AssertionError(f"[variants] {name}: launches {counts()}")
        want = fn(L[crop].cpu(), R[crop].cpu())
        agree = float((got.cpu() == want).double().mean())
        route_ms, disp = _wall_ms(lambda: fn(L, R), torch)
        if disp.shape != tuple(rect.canvas) or not torch.isfinite(disp).all():
            raise AssertionError(f"[variants] {name}: bad disparity {tuple(disp.shape)}")
        print(f"[variants] {name}: {agree:.6f} equal to the port on the CPU on a "
              f"240x320 crop; {tuple(rect.canvas)} D=200 {route_ms:.2f} ms (median of 3, "
              f"{smi})", flush=True)
        if agree < 0.995:
            raise AssertionError(f"[variants] {name}: CPU agreement {agree:.4%} < 99.5%")

    vol_ms, _ = _wall_ms(lambda: cv.cost_volume_left_ssd(L, R, 17, 200), torch)
    print(f"[variants] the Left volume alone {tuple(rect.canvas)} D=200: {vol_ms:.2f} ms "
          f"(median of 3, {smi}); the rest of block_search_left is the fixpoint smoother",
          flush=True)
    print(f"[variants] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)


def uncalibrated_phase(torch, dev, smi, counts, reset_counts, expected, h=750, w=900,
                       device_args=()):
    """Phase 13: ``run_uncalibrated`` with every detector, and the
    ``rectify`` subcommand as a subprocess (``device_args`` passed to it;
    the card by default)."""
    from stereo_reconstruction_tpu_torch.config import PipelineConfig
    from stereo_reconstruction_tpu_torch.data import MiddEval3
    from stereo_reconstruction_tpu_torch.pipeline_uncalibrated import run_uncalibrated

    t_phase = time.perf_counter()
    left, right, K, *_ = nonplanar_scene(np.random.default_rng(SEED), h, w)
    config = PipelineConfig()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for detector in ("orb", "brisk", "dog"):
            out = os.path.join(tmp, detector)
            reset_counts()
            t0 = time.perf_counter()
            res = run_uncalibrated(left, right, config, detector=detector, output_dir=out,
                                   device=dev)
            wall = time.perf_counter() - t0
            if counts() != expected(K1b=1, warp=1):
                raise AssertionError(f"[uncalibrated] {detector}: launches {counts()}")
            pngs = all(os.path.exists(os.path.join(out, n)) for n in (
                "rectified_left.png", "rectified_right.png", "disparity_linear.png"))
            print(f"[uncalibrated] {detector} {h}x{w}: {res.num_inliers} inliers, epipolar "
                  f"alignment {res.epipolar_alignment_px:.4f} px, F_rectified "
                  f"{res.F_rectified is not None}, PNGs {pngs}, disparity "
                  f"{res.disparity.shape}, 1 K1b launch; {wall * 1e3:.1f} ms with the PNGs ({smi})",
                  flush=True)
            if not (res.num_inliers >= 30 and res.epipolar_alignment_px <= 2.0
                    and res.F_rectified is not None and pngs
                    and np.isfinite(res.disparity).all()):
                raise AssertionError(f"[uncalibrated] {detector} fails its gates")
            runs[detector] = res
        root = os.path.join(tmp, "MiddEval3")
        write_middeval_scene(root, "Nonplanar", left, right, K, ndisp=200)
        loaded = MiddEval3(root).load_training(0)
        if not np.array_equal(loaded.image_right, right):
            raise AssertionError("[uncalibrated] the tree does not load back equal")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "stereo_reconstruction_tpu_torch", "rectify", "--data", root,
             "--scenario", "0", "--out", os.path.join(tmp, "cli"), *device_args],
            cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
            timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"cli rectify exited {out.returncode}:\n{out.stderr}")
        line = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
        pngs = all(os.path.exists(os.path.join(tmp, "cli", n)) for n in (
            "rectified_left.png", "rectified_right.png", "disparity_linear.png"))
        if (len(line) != 1 or line[0]["num_inliers"] != runs["orb"].num_inliers
                or line[0]["F_rectified"] is None or not pngs):
            raise AssertionError(f"[uncalibrated] cli rectify: {line}, PNGs {pngs}; the "
                                 f"in-process orb run has {runs['orb'].num_inliers} inliers")
    print(f"[uncalibrated] cli rectify as a subprocess ({time.perf_counter() - t0:.1f} s): "
          f"{line[0]['num_inliers']} inliers, as the in-process orb run; phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


def _search_split(call, torch):
    """(device ms by part, device ms in all, wall ms) of one profiled call
    of the perceptual search: the cuDNN convolutions, the Gram products
    (bmm), K4, and the rest; ({}, 0, wall) if the profiler saw no device
    work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    parts, total = {"convolutions": 0.0, "gram": 0.0, "K4": 0.0}, 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) / 1e3
        if e.device_type == DeviceType.CUDA:
            total += us
            if KERNEL_NAMES["K4"] in e.key:
                parts["K4"] += us
        elif e.key == "aten::cudnn_convolution":
            parts["convolutions"] += us
        elif e.key == "aten::bmm":
            parts["gram"] += us
    if total == 0.0:
        return {}, 0.0, wall_ms
    parts["other"] = total - sum(parts.values())
    return parts, total, wall_ms


def perceptual_phase(torch, dev, smi, counts, reset_counts, expected, h=375, w=450, D=100,
                     oracle_rows=(11, 131, 252, 304), edge_rows=(370, 373),
                     cli_args=("--device", "cuda")):
    """Phase 14: the perceptual matcher (BASELINE config 3) at (h, w), D,
    window 17, chunk 20, full VGG-16 widths with the seed-0 He-init
    weights; the notebook oracle gates ``oracle_rows`` and prints
    ``edge_rows``; ``cli_args`` are added to the CLI's. Returns K4's
    (launches, max abs err, (ms, plain ms), bound)."""
    from stereo_reconstruction_tpu_torch.config import PerceptualConfig, PipelineConfig
    from stereo_reconstruction_tpu_torch.data.records import StereoPair
    from stereo_reconstruction_tpu_torch.io.pfm import read_pfm
    from stereo_reconstruction_tpu_torch.ops.warp import warp_perspective
    from stereo_reconstruction_tpu_torch.perceptual import cost as pcost
    from stereo_reconstruction_tpu_torch.perceptual import scan as pscan
    from stereo_reconstruction_tpu_torch.perceptual.notebook_oracle import notebook_rows
    from stereo_reconstruction_tpu_torch.perceptual.vgg import vgg_module
    from stereo_reconstruction_tpu_torch.pipeline import run_pair
    from stereo_reconstruction_tpu_torch.rectify.rectifier import (
        disparity_to_original_frame,
        rectify_pair,
    )

    t_phase = time.perf_counter()
    # K4 against its twin on planted volumes: ties, W not a multiple of the
    # chunk, W = 1, chunk 1 and 20, the clamp mean == size, chunk > W; NaN,
    # +0.0 and -0.0 ("specials"), H = 1 and H < len, D = 33 and 200, a warp
    # with several positions (chunk 33, 64), W = chunk + 1; 3, 2, 1 and no
    # staged rows a position (D 150-600 at chunk 100-150)
    max_err, clamps = 0.0, 0
    cases = [(6, 12, 50, 20, False), (5, 12, 50, 20, True), (4, 7, 1, 20, False),
             (5, 8, 33, 1, True), (4, 40, 45, 20, False), (3, 30, 70, 7, True),
             (3, 12, 40, 64, False), (4, 100, 450, 20, True), (2, 200, 700, 20, False),
             (5, 12, 50, 20, "specials"), (4, 100, 450, 20, "specials"),
             (1, 12, 50, 20, False), (3, 12, 60, 20, True), (4, 33, 50, 20, False),
             (3, 200, 450, 20, True), (3, 12, 20, 1, "specials"), (4, 12, 70, 33, True),
             (3, 40, 130, 64, "specials"), (4, 12, 21, 20, False), (3, 150, 127, 120, True),
             (2, 200, 127, 120, False), (2, 300, 157, 150, "specials"),
             (2, 600, 107, 100, False)]
    for ph, pd, pw, chunk, ties in cases:
        vol = torch.from_numpy(perceptual_volume(
            np.random.default_rng(pw + chunk), ph, pd, pw, ties=ties is True,
            specials=ties == "specials")).to(dev)
        table = pscan.weight_table(pd, 25.0, 0.85, dev)
        got = pscan.window_scan(vol, table, chunk)
        want = pscan.window_scan_plain(vol, table, chunk)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K4 != plain twin on planted volume {(ph, pd, pw, chunk, ties)}: "
                                 f"{(got != want).float().mean().item():.3%} of pixels")
        sizes = torch.clamp(pw - torch.arange(pw, device=dev), max=pd)
        pos = (torch.arange(1, pw, device=dev) % chunk) != 0
        clamps += int(((want[:, :-1] >= sizes[1:]) & pos).sum())
        max_err = max(max_err, _max_abs_err(got, want))
    if clamps == 0:
        raise AssertionError("no planted case reached the clamp mean == size")
    print(f"[perceptual] K4 bit-equal to its twin on {len(cases)} planted volumes (ties, "
          f"NaN and +-0.0, H 1 to 6, W 1 to 700, D 7 to 600, chunk 1 to 150, 0 to 4 staged "
          f"rows; {clamps} pixels at the clamp mean == size)", flush=True)

    # the windowed search at full width on a shifted random texture
    d0 = 9
    left_np, right_np = perceptual_pair(np.random.default_rng(SEED), h, w, shift=d0)
    left, right = torch.from_numpy(left_np).to(dev), torch.from_numpy(right_np).to(dev)
    pcfg = PerceptualConfig(max_disparity=D)                 # window 17, chunk 20
    module = vgg_module("", seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    disp = pcost.windowed_lpips_search(module, left, right, pcfg)
    torch.cuda.synchronize()
    if counts() != expected(K4=1):
        raise AssertionError(f"windowed search launches {counts()}: want one K4")
    launches = counts()["K4"]
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if disp.shape != (h, w) or not torch.isfinite(disp).all():
        raise AssertionError(f"windowed search: bad disparity {tuple(disp.shape)}")
    disp_np = disp.cpu().numpy()
    interior = disp_np[8:h - 8, 8:w - D - 8]
    recovered = float(np.mean(np.abs(interior - d0) <= 1))
    widths = "/".join(str(convs[-1].out_channels) for convs in module.blocks)
    print(f"[perceptual] windowed search {h}x{w} D={D} window 17 chunk 20, VGG-16 "
          f"{widths}: one K4 launch; {recovered:.6f} of interior pixels within "
          f"1 px of the planted {d0}; peak {peak_gib:.2f} GiB", flush=True)
    if recovered < 0.95:
        raise AssertionError(f"shift recovery {recovered:.4%} < 95%")
    vol_ms, volume = _wall_ms(lambda: pcost.windowed_lpips_cost_volume(module, left, right, pcfg),
                              torch, repeats=2)
    search_ms, _ = _wall_ms(lambda: pcost.windowed_lpips_search(module, left, right, pcfg),
                            torch, repeats=2)
    table = pscan.weight_table(D, pcfg.smoothing_sigma, pcfg.smoothing_bias, dev)
    got = pscan.window_scan(volume, table, pcfg.chunk)
    want = pscan.window_scan_plain(volume, table, pcfg.chunk)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K4 != plain twin on the scene's windowed volume")
    max_err = max(max_err, _max_abs_err(got, want))
    k4_ms = _median_ms(lambda: pscan.window_scan(volume, table, pcfg.chunk), torch, CALLS)
    plain_ms = _median_ms(lambda: pscan.window_scan_plain(volume, table, pcfg.chunk), torch)
    from stereo_reconstruction_tpu_torch.utils.roofline import window_scan_bound

    bound = window_scan_bound(h, D, w)
    print(f"[perceptual] {smi}: cost volume {vol_ms:.1f} ms, whole search {search_ms:.1f} ms "
          f"(host clock, median of 2 after a warm-up); K4 {k4_ms:.4f} ms, bit-equal to its "
          f"twin ({plain_ms:.2f} ms) on the volume (CUDA events, median of {REPEATS}); "
          f"bound {bound[0]:.4f} ms ({bound[1]})", flush=True)
    # K4's chain: one chunk strip alone (its H + chunk - 1 diagonals) against
    # the whole width (the same chain in every strip at once)
    strip = volume[:, :, :pcfg.chunk].contiguous()
    strip_ms = _median_ms(lambda: pscan.window_scan(strip, table, pcfg.chunk), torch, CALLS)
    diagonals = h + pcfg.chunk - 1
    print(f"[perceptual] K4 chain: one {pcfg.chunk}-column strip {strip_ms:.4f} ms, "
          f"{diagonals} diagonals, {strip_ms / diagonals * 1e3:.4f} us a diagonal; the "
          f"{-(-w // pcfg.chunk)} strips of the width {k4_ms:.4f} ms", flush=True)
    del volume
    split, device_ms, wall_ms = _search_split(
        lambda: pcost.windowed_lpips_search(module, left, right, pcfg), torch)
    print("[perceptual] profiled windowed search: " + (
        ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        + f" device ms; {device_ms:.1f} ms on the device in {wall_ms:.1f} ms wall "
        f"({100 * device_ms / wall_ms:.1f}% busy)" if split else
        "split not measured (the profiler saw no device work)"), flush=True)

    # semantics: the port's notebook oracle, fed the search's own row y-1
    rows = notebook_rows(module, left_np, right_np, oracle_rows + edge_rows, disp_np,
                         max_disparity=D, chunk=pcfg.chunk, device=dev)
    for y, row in rows.items():
        exact = float(np.mean(row == disp_np[y]))
        within2 = float(np.mean(np.abs(row - disp_np[y]) <= 2))
        edge = y in edge_rows
        print(f"[perceptual] notebook oracle row {y}: {exact:.6f} exact, {within2:.6f} "
              f"within 2 px{' (bottom edge, not gated)' if edge else ''}", flush=True)
        if not edge and (within2 < 1.0 or exact < 0.98):
            raise AssertionError(f"oracle row {y}: {exact:.4%} exact, {within2:.4%} within 2 px")

    # the full-image approximation at the same size
    fcfg = PerceptualConfig(max_disparity=D, mode="full_image")
    full_ms, full = _wall_ms(lambda: pcost.perceptual_window_search(module, left, right, fcfg),
                             torch, repeats=2)
    full_np = full.cpu().numpy()
    print(f"[perceptual] full_image mode: {full_ms:.1f} ms; {np.mean(full_np == disp_np):.6f} "
          f"equal to the windowed search, {np.mean(np.abs(full_np - disp_np) <= 1):.6f} within "
          f"1 px; {np.mean(np.abs(full_np[8:h - 8, 8:w - D - 8] - d0) <= 1):.6f} of interior "
          f"pixels within 1 px of {d0}", flush=True)

    # run_pair with a known F on the smoke's plane scene at 375x450
    rng = np.random.default_rng(SEED)
    left_np, H_lr, F, K = _synthetic_scene(rng, h, w)
    right_np = warp_perspective(torch.from_numpy(left_np).to(dev),
                                torch.as_tensor(H_lr, dtype=torch.float32, device=dev),
                                left_np.shape[:2])
    right_np = right_np.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    gt, mask = _true_disparity(H_lr, F, h, w)
    pair = StereoPair(left_np, right_np, K.astype(np.float32), K.astype(np.float32),
                      disp_right_gt=gt, mask_right_nocc=mask, name="perceptual")
    config = PipelineConfig()
    config = config.replace(matcher=dataclasses.replace(config.matcher, cost="perceptual",
                                                        max_disparity=D))
    runs = []
    for _ in range(2):
        reset_counts()
        res = run_pair(pair, config, fixed_F=F, device=dev)
        if counts() != expected(K4=1, warp=2):
            raise AssertionError(f"perceptual run_pair launches {counts()}: want one K4 "
                                 f"and two warps")
        runs.append(res)
    rect = rectify_pair(torch.from_numpy(left_np).to(dev), torch.from_numpy(right_np).to(dev), F)
    direct = pcost.windowed_lpips_search(module, rect.left, rect.right, pcfg)
    direct = disparity_to_original_frame(direct, rect.homographies.H_right, (h, w)).cpu().numpy()
    res = runs[0]
    agree = float(np.mean(res.disparity == direct))
    m = res.metrics
    print(f"[perceptual] run_pair(fixed_F=F) {h}x{w} D={D} on the {tuple(rect.canvas)} canvas: "
          f"one K4 launch; {agree:.6f} of pixels equal to a direct windowed search on the same "
          f"rectified pair, back-warped; {np.mean(runs[1].disparity == res.disparity):.6f} equal "
          f"between two runs; evaldisp vs the true disparity: bad-2.0 {m['bad_percent']:.3f}%, "
          f"invalid {m['invalid_percent']:.3f}%; stage ms of run 2: "
          + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in runs[1].timings.items()), flush=True)
    if res.disparity.shape != (h, w) or not np.isfinite(res.disparity).all() or agree < 0.995:
        raise AssertionError(f"perceptual run_pair: agreement {agree:.4%} < 99.5% or bad output")

    # the command line, as a subprocess, on a MiddEval3 tree of the scene
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        root, out_dir = os.path.join(tmp, "MiddEval3"), os.path.join(tmp, "out")
        write_middeval_scene(root, "Perceptual", left_np, right_np, K, ndisp=D, gt=gt,
                             mask=mask)
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "stereo_reconstruction_tpu_torch", "run",
                              "--data", root, "--scenario", "0", "--matcher", "perceptual",
                              "--max-disparity", str(D), "--out", out_dir, *cli_args],
                             cwd=repo, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        if out.returncode != 0:
            raise AssertionError(f"cli run --matcher perceptual exited {out.returncode}:\n"
                                 f"{out.stderr}")
        lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
        staged = read_pfm(os.path.join(out_dir, "Perceptual_disp.pfm"))
        if len(lines) != 1 or staged.shape != (h, w) or not np.isfinite(staged).all():
            raise AssertionError(f"cli run --matcher perceptual: {lines}, {staged.shape}")
    print(f"[perceptual] python -m stereo_reconstruction_tpu_torch run --matcher perceptual "
          f"{' '.join(cli_args)}: {cli_s:.1f} s, pose_ok {lines[0]['metrics']['pose_ok']}, bad-2.0 "
          f"{lines[0]['metrics']['bad_percent']:.3f}%; phase took "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, max_err, (k4_ms, plain_ms), bound


def synthetic_sequence(rng, M=4, n_grid=8):
    """M cameras on an arc over a jittered grid of n_grid^2 points at depth
    8-12 (tests/test_ba_multiview.py's sequence): (K, poses (M, 6)
    angle-axis + translation, camera 0 at the origin, points (N, 3),
    observations (M, N, 2))."""
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    g = np.linspace(-2, 2, n_grid)
    xx, yy = np.meshgrid(g, g)
    zz = 10.0 + rng.uniform(-2, 2, xx.shape)
    X = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=1)
    poses = np.zeros((M, 6))
    obs = np.zeros((M, X.shape[0], 2))
    for m in range(M):
        if m:
            poses[m, :3] = [0.0, 0.08 * m, 0.02 * m]
            poses[m, 3:] = [0.5 * m, 0.05 * m, 0.1 * m]
        R = _rodrigues(poses[m, :3]) if m else np.eye(3)
        p = (X @ R.T + poses[m, 3:]) @ K.T
        obs[m] = p[:, :2] / p[:, 2:3]
    return K, poses, X, obs


def sharded_phase(torch, dev, smi, counts, reset_counts, expected, h=1128, w=1408, D=200,
                  bs=17, backend="nccl"):
    """The multi-device layer on one card: a data=2, tile=4 mesh over
    ``cuda:0`` x 8 (282-row tiles at the reference canvas); ``backend``
    is the process group's."""
    from stereo_reconstruction_tpu_torch.config import (BundleAdjustmentConfig,
                                                        MatcherConfig, PipelineConfig)
    from stereo_reconstruction_tpu_torch.data.records import StereoPair
    from stereo_reconstruction_tpu_torch.ops import cuda_cost_volume as ccv
    from stereo_reconstruction_tpu_torch.ops import cuda_row_scan as crs
    from stereo_reconstruction_tpu_torch.ops import geometry as geo
    from stereo_reconstruction_tpu_torch.ops import smoothing
    from stereo_reconstruction_tpu_torch.ops.block_search import block_search_right
    from stereo_reconstruction_tpu_torch.ops.cost_volume import black_pixel_mask
    from stereo_reconstruction_tpu_torch.ops.metrics import evaldisp
    from stereo_reconstruction_tpu_torch.parallel import (
        ba_multiview, distributed_bundle_adjust, distributed_bundle_adjust_batch,
        make_mesh, multihost, sharded_block_search_right, sharded_evaldisp)
    from stereo_reconstruction_tpu_torch.pipeline import estimate_pose
    from stereo_reconstruction_tpu_torch.pose.ba import bundle_adjust
    from stereo_reconstruction_tpu_torch.utils.roofline import matcher_bound, scan_bound

    t_phase = time.perf_counter()
    data, n_tiles = 2, 4
    mesh = make_mesh(data=data, tile=n_tiles, devices=[dev] * (data * n_tiles))
    rows, hw = h // n_tiles, bs - 1
    rng = np.random.default_rng(SEED + 15)
    pairs = [_random_stereo(rng, h, w) for _ in range(data)]
    left = torch.from_numpy(np.stack([p[0] for p in pairs])).to(dev)
    right = torch.from_numpy(np.stack([p[1] for p in pairs])).to(dev)
    lf, rf = left[0].float(), right[0].float()
    args = (bs, 0, D)
    out = {}

    # K1 and K2 in global mode on every halo-extended tile of pair 0: the
    # exact mode's (hw rows of halo) and the warm-up mode's (32 + hw above)
    whole_k1 = ccv.matcher_inputs(lf, rf, *args)
    whole_k2 = ccv.cost_volume(lf, rf, *args)
    k1_rows = [[] for _ in whole_k1]
    k2_rows = []
    n_checked = 0
    for top in (hw, 32 + hw):
        for t in range(n_tiles):
            row0, n = t * rows - top, top + rows + hw
            lt, rt = halo_tile(lf, row0, n), halo_tile(rf, row0, n)
            g = dict(row_offset=row0, total_height=h)
            planes = ccv.matcher_inputs(lt, rt, *args, **g)
            twin = ccv.matcher_inputs_plain(lt, rt, *args, **g)
            vol = ccv.cost_volume(lt, rt, *args, **g)
            vol_twin = ccv.cost_volume_right_ssd(lt, rt, *args, **g)
            torch.cuda.synchronize()
            for name, a, b in zip(("m0", "a0", "c_zero", "diag_up", "diag_lf"), planes, twin):
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise AssertionError(f"K1 global rows != twin, tile {t} (halo {top}), {name}")
            if not torch.equal(vol, vol_twin):
                raise AssertionError(f"K2 global rows != twin, tile {t} (halo {top})")
            if top == hw:          # the kept rows, stitched below
                for i, a in enumerate(planes):
                    k1_rows[i].append(a[hw:hw + rows])
                k2_rows.append(vol[:, hw:hw + rows])
            n_checked += 1
            del twin, vol_twin
    for name, parts, a in zip(("m0", "a0", "c_zero", "diag_up", "diag_lf"), k1_rows, whole_k1):
        if not torch.equal(torch.cat(parts), a):
            raise AssertionError(f"K1 tiles stitched != K1 on the whole image, {name}")
    if not torch.equal(torch.cat(k2_rows, dim=1), whole_k2):
        raise AssertionError("K2 tiles stitched != K2 on the whole image")
    del whole_k2, k2_rows
    # one inner tile's times
    row0, n = rows - hw, rows + 2 * hw
    lt, rt = halo_tile(lf, row0, n), halo_tile(rf, row0, n)
    g = dict(row_offset=row0, total_height=h)
    tile_shape = dict(h=n, w=w, wl_extra=0, bs=bs, min_d=0, max_d=D)
    for name, kern, plain, planes_out in (
            ("K1", ccv.matcher_inputs, ccv.matcher_inputs_plain, 5),
            ("K2", ccv.cost_volume, ccv.cost_volume_right_ssd, D)):
        k_ms = _median_ms(lambda: kern(lt, rt, *args, **g), torch, CALLS)
        p_ms = _median_ms(lambda: plain(lt, rt, *args, **g), torch)
        out[name] = (k_ms, p_ms, matcher_bound(tile_shape, planes_out))
    print(f"[sharded] {smi}: K1 and K2 in global-row mode bit-equal to their twins on "
          f"{n_checked} halo-extended tiles of a {h}x{w} D={D} block {bs} pair (integer "
          f"valued), the kept rows stitched bit-equal to K1 / K2 on the whole image; one "
          f"{n}-row tile: K1 {out['K1'][0]:.4f} ms (plain {out['K1'][1]:.2f}, bound "
          f"{out['K1'][2][0]:.4f}), K2 {out['K2'][0]:.4f} ms (plain {out['K2'][1]:.2f}, "
          f"bound {out['K2'][2][0]:.4f}); CUDA events, median of {REPEATS}", flush=True)

    # K1b seeded: planted planes with random first flags and seed rows, at
    # widths from one strip to the widest row
    planted = ((9, 33, 0), (7, 700, 2), (6, 1100, 1), (6, 2500, 0), (5, crs.max_width(), 1))
    for hh, ww, d_first in planted:
        srng = np.random.default_rng(SEED + ww)
        cost, black = scan_volume(srng, hh, ww, 12)
        planes = smoothing.volume_reductions(torch.from_numpy(cost).to(dev), d_first)
        black = torch.from_numpy(black).to(dev)
        first = torch.from_numpy(srng.random(hh) < 0.3).to(dev)
        xs = np.arange(ww, dtype=np.float32)
        seed = np.choose(srng.integers(0, 3, ww),
                         [np.zeros(ww, np.float32), -xs, srng.integers(0, 12, ww)])
        seed = torch.from_numpy(seed.astype(np.float32)).to(dev)
        scan = dict(smooth_factor=0.9, d_first=d_first, n_planes=12, first_flags=first,
                    init_prev=seed)
        got = crs.row_scan(*planes, black, **scan)
        want = smoothing.smoothed_argmin_from_inputs(*planes, black, **scan)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1b seeded != twin on planted planes {hh}x{ww}")
    # and across its strip boundaries (chain planes)
    for ww in STRIP_WIDTHS:
        for hh in (1, 2, 282, 1128):
            srng = np.random.default_rng(SEED + 17 * ww + hh)
            *planes, black = (torch.from_numpy(a).to(dev)
                              for a in chain_planes(srng, hh, ww, 12, (ww + hh) % 2 == 0))
            first, seed = (torch.from_numpy(a).to(dev) for a in seed_rows(srng, hh, ww, 12))
            scan = dict(smooth_factor=0.9, d_first=ww % 3, n_planes=12, first_flags=first,
                        init_prev=seed)
            got = crs.row_scan(*planes, black, **scan)
            want = smoothing.smoothed_argmin_from_inputs(*planes, black, **scan)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K1b seeded != twin on chain planes {hh}x{ww}")
    # a chain of row tiles, each seeded with the last row of the one before,
    # equals one launch over the whole height
    black = black_pixel_mask(rf)
    scan = dict(smooth_factor=0.9, d_first=0, n_planes=D)
    whole = crs.row_scan(*whole_k1, black, **scan)
    seed, parts = torch.zeros(w, device=dev), []
    never = torch.zeros(rows, dtype=torch.bool, device=dev)
    for t in range(n_tiles):
        sl = slice(t * rows, (t + 1) * rows)
        first = never.clone()
        first[0] = t == 0
        parts.append(crs.row_scan(*(p[sl] for p in whole_k1), black[sl], **scan,
                                  first_flags=first, init_prev=seed))
        seed = parts[-1][-1]
    if not torch.equal(torch.cat(parts), whole):
        raise AssertionError("seeded K1b tile chain != one K1b launch over the image")
    # the tiles the sharded matcher scans, against the twin: tile 1 seeded
    # with tile 0's last row (the exact mode's), and tile 1 with its warm-up
    # rows above it (32 at full size), local row 0 cut (the warm-up mode's)
    wu = min(32, rows - hw)
    cut = torch.zeros(wu + rows, dtype=torch.bool, device=dev)
    cut[0] = True
    for sl, flags in ((slice(rows, 2 * rows), never), (slice(rows - wu, 2 * rows), cut)):
        kw = dict(scan, first_flags=flags, init_prev=parts[0][-1])
        got = crs.row_scan(*(p[sl] for p in whole_k1), black[sl], **kw)
        want = smoothing.smoothed_argmin_from_inputs(*(p[sl] for p in whole_k1), black[sl],
                                                     **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K1b seeded != twin on the {sl.stop - sl.start}-row tile "
                                 f"{h}x{w} D={D}")
    sl = slice(rows, 2 * rows)
    tile_planes = [p[sl].contiguous() for p in whole_k1]
    seeded = dict(scan, first_flags=never, init_prev=parts[0][-1])
    out["K1b"] = (_median_ms(lambda: crs.row_scan(*tile_planes, black[sl], **seeded), torch,
                             CALLS),
                  _median_ms(lambda: smoothing.smoothed_argmin_from_inputs(
                      *tile_planes, black[sl], **seeded), torch),
                  scan_bound(rows, w))
    print(f"[sharded] {smi}: K1b seeded bit-equal to its twin on {len(planted)} planted "
          f"cases (W 33 to {crs.max_width()}, random first flags and seed rows), on chain "
          f"planes at W {', '.join(map(str, STRIP_WIDTHS))} x H 1, 2, 282, 1128, and on "
          f"the matcher's {rows}-row seeded tile and {wu + rows}-row warm-up "
          f"tile of the {h}x{w} D={D} pair; {n_tiles} seeded tiles chained bit-equal to "
          f"one launch over {h} rows; one {rows}-row seeded tile {out['K1b'][0]:.4f} ms "
          f"(plain {out['K1b'][1]:.2f}, bound {out['K1b'][2][0]:.4f})", flush=True)
    del whole_k1, tile_planes

    # the exact sharded matcher: one K1 per (pair, tile), n_tiles K1b each
    cfg = MatcherConfig(block_size=bs, max_disparity=D)
    reset_counts()
    disp = sharded_block_search_right(left, right, mesh, cfg, exact=True)
    torch.cuda.synchronize()
    want = expected(K1=data * n_tiles, K1b=data * n_tiles * n_tiles)
    if counts() != want:
        raise AssertionError(f"exact sharded matcher launches {counts()}, want {want}")
    launches = counts()
    single = torch.stack([block_search_right(left[i], right[i], cfg) for i in range(data)])
    if disp.shape != (data, h, w) or not torch.equal(disp, single):
        raise AssertionError("exact sharded matcher != block_search_right on "
                             f"{(disp != single).float().mean().item():.4%} of pixels")
    exact_ms, _ = _wall_ms(lambda: sharded_block_search_right(left, right, mesh, cfg,
                                                              exact=True), torch)
    single_ms, _ = _wall_ms(lambda: [block_search_right(left[i], right[i], cfg)
                                     for i in range(data)], torch)
    reset_counts()
    warm = sharded_block_search_right(left, right, mesh, cfg, warmup=32)
    torch.cuda.synchronize()
    if counts() != expected(K1=data * n_tiles, K1b=data * n_tiles):
        raise AssertionError(f"warm-up sharded matcher launches {counts()}")
    agree = float((warm == single).double().mean())
    if agree < 0.995:
        raise AssertionError(f"warm-up sharded matcher agreement {agree:.4%} < 99.5%")
    warm_ms, _ = _wall_ms(lambda: sharded_block_search_right(left, right, mesh, cfg,
                                                             warmup=32), torch)
    print(f"[sharded] {smi}: sharded_block_search_right on a data=2, tile=4 mesh over "
          f"cuda:0 x 8, {data} pairs {h}x{w} D={D} block {bs}: exact=True bit-identical to "
          f"block_search_right with {launches['K1']} K1 and {launches['K1b']} K1b launches "
          f"(one K1 per pair and tile, {n_tiles} seeded K1b passes each), {exact_ms:.2f} ms; "
          f"exact=False (warm-up 32) agreement {agree:.6f}, {data * n_tiles} K1 + "
          f"{data * n_tiles} K1b, {warm_ms:.2f} ms; two block_search_right calls "
          f"{single_ms:.2f} ms (host clock, median of 3 after a warm-up)", flush=True)

    # sharded_evaldisp: one psum of the four counts
    grng = np.random.default_rng(SEED + 16)
    gt = single + torch.from_numpy(grng.normal(0, 2, single.shape).astype(np.float32)).to(dev)
    mask = torch.from_numpy(np.where(grng.random(single.shape) < 0.8, 255, 0)
                            .astype(np.uint8)).to(dev)
    got = sharded_evaldisp(single, gt, mask, mesh, bad_thresh=2.0, max_disp=float(D))
    ref = evaldisp(single.reshape(-1, w), gt.reshape(-1, w), mask.reshape(-1, w),
                   bad_thresh=2.0, max_disp=float(D))
    d_bad = abs(float(got["bad_percent"]) - float(ref["bad_percent"]))
    r_err = abs(float(got["avg_err"]) / float(ref["avg_err"]) - 1)
    if not (d_bad <= 0.05 and r_err <= 1e-3):
        raise AssertionError(f"sharded_evaldisp {got} vs evaldisp {ref}")
    print(f"[sharded] sharded_evaldisp equals evaldisp of the batch: bad-2.0 "
          f"{float(got['bad_percent']):.4f}% (|diff| {d_bad:.2e}), avg err "
          f"{float(got['avg_err']):.4f} (rel diff {r_err:.2e})", flush=True)

    # the distributed BAs on the pose stage's matches of the non-planar scene
    srng = np.random.default_rng(SEED)
    left_np, right_np, K, _, _, _, _ = nonplanar_scene(srng)
    pcfg = PipelineConfig()
    pcfg = pcfg.replace(ba=dataclasses.replace(pcfg.ba, num_points=64))   # 8 | 64
    pair = StereoPair(left_np, right_np, K.astype(np.float32), K.astype(np.float32))
    pose = estimate_pose(pair, pcfg, device=dev)
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    kp_l, kp_r, wts = pose.keypoints_left, pose.keypoints_right, pose.weights
    R_r, T_r = pose.pose_ransac[:3, :3], pose.pose_ransac[:3, 3]
    xl, xr = geo.normalize_points(Kt, kp_l), geo.normalize_points(Kt, kp_r)
    pts0 = xl * geo.triangulate_depths(xl, xr, R_r, T_r)[None, :]
    bcfg = BundleAdjustmentConfig(max_iterations=10)
    problems = []
    for i in range(3):      # the RANSAC pose, perturbed as tests/test_sharding.py does
        aa = geo.rotation_to_angle_axis(R_r) + 0.03 + 0.01 * i
        problems.append((geo.angle_axis_to_rotation(aa), T_r + 0.05))
    R0, T0 = problems[0]
    res_d = distributed_bundle_adjust(kp_l, kp_r, Kt, Kt, R0, T0, pts0, mesh, weights=wts,
                                      config=bcfg)
    res_s = bundle_adjust(kp_l, kp_r, Kt, Kt, R0, T0, pts0, weights=wts, config=bcfg)
    d_rot = float((res_d.rotation - res_s.rotation).abs().max())
    d_t = float((res_d.translation - res_s.translation).abs().max())
    c_d, c_s = float(res_d.final_cost), float(res_s.final_cost)
    if not (d_rot <= 1e-3 and d_t <= 5e-3 and abs(c_d - c_s) <= 1e-3 + 0.05 * abs(c_s)):
        raise AssertionError(f"distributed BA vs single: {d_rot}, {d_t}, {c_d} vs {c_s}")
    B = len(problems)
    stack = lambda t: torch.stack([t] * B)     # noqa: E731
    poses, _, c0, cf, _ = distributed_bundle_adjust_batch(
        stack(kp_l), stack(kp_r), Kt, Kt, torch.stack([p[0] for p in problems]),
        torch.stack([p[1] for p in problems]), stack(pts0), mesh, weights=stack(wts),
        config=bcfg)
    d_batch = 0.0
    for i, (Ri, Ti) in enumerate(problems):
        res_i = distributed_bundle_adjust(kp_l, kp_r, Kt, Kt, Ri, Ti, pts0, mesh,
                                          weights=wts, config=bcfg)
        d_batch = max(d_batch, float((poses[i] - res_i.pose).abs().max()))
        ci, fi = float(cf[i]), float(res_i.final_cost)
        if not (abs(ci - fi) <= 1e-4 + 0.05 * abs(fi) and ci < 0.05 * float(c0[i])):
            raise AssertionError(f"BA batch pair {i}: cost {ci} vs {fi}, initial {float(c0[i])}")
    if d_batch > 2e-3:
        raise AssertionError(f"BA batch poses {d_batch} from the per-pair solves")
    print(f"[sharded] distributed_bundle_adjust on the non-planar scene's 64 BA matches "
          f"({int(wts.sum())} real) vs bundle_adjust: rotation {d_rot:.2e}, translation "
          f"{d_t:.2e}, final cost {c_d:.5f} vs {c_s:.5f}; the batch of {B} (one (B, 42) "
          f"psum a step) within {d_batch:.2e} of per-pair solves, costs "
          f"{float(c0.max()):.1f} -> {float(cf.max()):.5f} at most", flush=True)

    # multi-view BA: single device vs the points over the mesh, and the fused cloud
    mrng = np.random.default_rng(SEED)
    K3, poses_gt, X_gt, obs = synthetic_sequence(mrng, M=4, n_grid=8)
    X0 = X_gt + mrng.normal(0, 0.1, X_gt.shape)
    poses0 = poses_gt.copy()
    poses0[1:, 3:] += mrng.normal(0, 0.05, (3, 3))
    margs = [torch.as_tensor(a, dtype=torch.float32, device=dev)
             for a in (obs, np.stack([K3] * 4), poses0, X0)]
    mcfg = BundleAdjustmentConfig(loss="l2", max_iterations=15)
    mv_single = ba_multiview.multiview_bundle_adjust(*margs, config=mcfg)
    mv_mesh = make_mesh(data=4, tile=2, devices=[dev] * 8)
    mv_dist = ba_multiview.distributed_multiview_bundle_adjust(*margs, mesh=mv_mesh,
                                                               config=mcfg)
    sp, sx = mv_single.poses.cpu().numpy(), mv_single.points.cpu().numpy()
    dp, dx = mv_dist.poses.cpu().numpy(), mv_dist.points.cpu().numpy()
    ap, ax, scale = scale_aligned(dp, dx, sx)
    raw = (float(np.abs(dp - sp).max()), float(np.abs(dx - sx).max()))
    aligned = (float(np.abs(ap - sp).max()), float(np.abs(ax - sx).max()))
    d_rot_mv = float(np.abs(dp[:, :3] - sp[:, :3]).max())
    fused = ba_multiview.fuse_point_cloud(mv_dist.points, mv_mesh)
    # the gauge takes rounding, not a drift: the factor stays within 5e-3 of 1
    if not (d_rot_mv <= 2e-3 and aligned[0] <= 2e-3 and aligned[1] <= 5e-3
            and abs(scale - 1) <= 5e-3):
        raise AssertionError(f"multi-view BA: rotations {d_rot_mv}, aligned {aligned}, "
                             f"scale factor {scale}")
    if not (float(mv_dist.final_cost) < 1e-3 * float(mv_dist.initial_cost)
            and torch.equal(fused, mv_dist.points)):
        raise AssertionError("multi-view BA did not converge or the fused cloud differs")
    print(f"[sharded] distributed_multiview_bundle_adjust (4 cameras, 64 points over a "
          f"data=4, tile=2 mesh) vs multiview_bundle_adjust: rotations {d_rot_mv:.2e}; "
          f"translations / points {aligned[0]:.2e} / {aligned[1]:.2e} up to the scale "
          f"gauge (factor {scale:.6f}, |1 - factor| <= 5e-3; raw {raw[0]:.2e} / "
          f"{raw[1]:.2e}); cost "
          f"{float(mv_dist.initial_cost):.1f} -> {float(mv_dist.final_cost):.2e}; "
          f"fuse_point_cloud equal", flush=True)

    # the process-group mesh: a world of one on NCCL, initialised from a file
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        multihost.initialize("file://" + os.path.join(tmp, "store"), 1, 0, backend=backend)
        try:
            pg = multihost.global_mesh(data=1, tile=1)
            got = sharded_block_search_right(left, right, pg, cfg, exact=True)
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    if not torch.equal(got, disp):
        raise AssertionError(f"the {backend} process-group mesh != the one-process mesh")
    print(f"[sharded] {backend} process group of one (file:// store): the exact sharded "
          f"matcher equals the one-process mesh's output bit for bit", flush=True)
    print(f"[sharded] phase took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out, launches


def time_kernels(only=()) -> int:
    """``python3 chip_smoke.py --time-kernels [K1 K1b K2 K3 K4 warp ransac]``: K1,
    K1b, K2 and K3 at shape (b) on the integer-valued pair, and K1b seeded on the
    exact sharded matcher's 282-row tile of it (``K1b_tile``); K4 on a
    planted ``perceptual_volume`` at 375x450, D=100, chunk 20, one 20-column
    strip of it alone (``K4_strip``: the chain of 394 diagonals) and at
    D=200 (``K4_D200``, the default config's D); the warp kernel on a
    750x900 non-planar scene's Loop-Zhang maps: both uint8 images onto the
    1128x1408 canvas, bilinear, one launch (``warp_rectify``), and a float32
    canvas back to 750x900, nearest (``warp_back``), each beside its plain
    twin on the card (``*_plain``) and its bound (``bound_ms``), the calls
    queued behind a sleeping kernel (``_median_queued_ms``); the RANSAC
    kernel (two launches) on the posed request's matches
    (``tests/data/posed_request_matches.npz``, 222 valid, padded to N = 500)
    with 256 hypotheses (``ransac``), beside its twin replayed from a CUDA
    graph as the pose stage replayed it before the kernel
    (``ransac_plain_graph``), queued the same way. Names given:
    only those kernels. CUDA events, median of REPEATS over CALLS back-to-back calls
    (K3 one call a sample), as one JSON line. It uses only arguments the
    wrappers have taken since seeded rows came in, so a copy of this file
    beside an older checkout times that checkout's kernels: run two
    versions in turns in one call (A, B, B, A) to compare them."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stereo_reconstruction_tpu_torch.config import MatcherConfig
    from stereo_reconstruction_tpu_torch.ops import cuda_block_search as cbs
    from stereo_reconstruction_tpu_torch.ops import cuda_cost_volume as ccv
    from stereo_reconstruction_tpu_torch.ops import cuda_row_scan as crs
    from stereo_reconstruction_tpu_torch.ops.cost_volume import black_pixel_mask
    from stereo_reconstruction_tpu_torch.perceptual import scan as pscan

    only = set(only) or {"K1", "K1b", "K2", "K3", "K4", "warp", "ransac"}
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    ms = {}
    if only & {"K1", "K1b", "K2", "K3"}:
        left_np, right_np = _random_stereo(np.random.default_rng(SEED), 1128, 1408)
        left = torch.from_numpy(left_np).to(dev, torch.float32)
        right = torch.from_numpy(right_np).to(dev, torch.float32)
        args = (left, right, 17, 0, 200)
        planes = ccv.matcher_inputs(*args)
        black = black_pixel_mask(right)
        # the exact sharded matcher's tile: rows 282-563, seeded with row 281
        rows = slice(282, 564)
        tile = [p[rows].contiguous() for p in planes]
        seeded = dict(n_planes=200, first_flags=torch.zeros(282, dtype=torch.bool, device=dev),
                      init_prev=crs.row_scan(*planes, black, n_planes=200)[281].contiguous())
        timers = {
            "K1": lambda: ccv.matcher_inputs(*args),
            "K1b": lambda: crs.row_scan(*planes, black, n_planes=200),
            "K1b_tile": lambda: crs.row_scan(*tile, black[rows], **seeded),
            "K2": lambda: ccv.cost_volume(*args),
        }
        for key, fn in timers.items():
            if key.split("_")[0] in only:
                ms[key] = _median_ms(fn, torch, CALLS)
        if "K3" in only:
            ms["K3"] = _median_ms(lambda: cbs.block_search_fused(left, right, MatcherConfig()),
                                  torch)
    if "K4" in only:
        for key, D in (("K4", 100), ("K4_D200", 200)):
            vol = torch.from_numpy(perceptual_volume(np.random.default_rng(SEED), 375, D,
                                                     450)).to(dev)
            table = pscan.weight_table(D, 25.0, 0.85, dev)
            ms[key] = _median_ms(lambda: pscan.window_scan(vol, table, 20), torch, CALLS)
            if D == 100:
                strip = vol[:, :, :20].contiguous()
                ms["K4_strip"] = _median_ms(lambda: pscan.window_scan(strip, table, 20), torch,
                                            CALLS)
    bounds = {}
    if "warp" in only:
        from stereo_reconstruction_tpu_torch.config import RectifyConfig
        from stereo_reconstruction_tpu_torch.ops.warp import host_inverse, warp_inverse_map, \
            warp_inverse_maps
        from stereo_reconstruction_tpu_torch.rectify.loop_zhang import loop_zhang_homographies
        from stereo_reconstruction_tpu_torch.rectify.rectifier import static_canvas
        from stereo_reconstruction_tpu_torch.utils.roofline import warp_bound

        left, right, _, _, _, F, _ = nonplanar_scene(np.random.default_rng(SEED), 750, 900)
        homs = loop_zhang_homographies(F, (750, 900), (750, 900))
        canvas = static_canvas((750, 900), (750, 900), RectifyConfig())
        imgs = [torch.from_numpy(x).to(dev) for x in (left, right)]
        maps = host_inverse(np.stack([homs.H_left, homs.H_right]))
        disp = torch.from_numpy(np.random.default_rng(SEED).uniform(0, 200, canvas)
                                .astype(np.float32)).to(dev)
        back = host_inverse(host_inverse(homs.H_right))[None]
        maps_d, back_d = maps.to(dev), back.to(dev)
        timers = {
            "warp_rectify": lambda: warp_inverse_maps(imgs, maps, canvas),
            "warp_rectify_plain": lambda: [warp_inverse_map(img, m, canvas)
                                           for img, m in zip(imgs, maps_d)],
            "warp_back": lambda: warp_inverse_maps([disp], back, (750, 900), "nearest"),
            "warp_back_plain": lambda: warp_inverse_map(disp, back_d[0], (750, 900), "nearest"),
        }
        for key, fn in timers.items():
            ms[key] = _median_queued_ms(fn, torch)
        bounds["warp_rectify"] = warp_bound(750, 900, 3, 1, *canvas, images=2)
        bounds["warp_back"] = warp_bound(*canvas, 1, 4, 750, 900, nearest=True)
    if "ransac" in only:
        from stereo_reconstruction_tpu_torch.config import RansacConfig
        from stereo_reconstruction_tpu_torch.pose.ransac import draw_uniforms
        from stereo_reconstruction_tpu_torch.utils.roofline import ransac_bound

        cfg = RansacConfig()
        ml, mr, nv = request_matches("posed_request_matches", 500)
        ml, mr, nv = ml.to(dev), mr.to(dev), torch.tensor(nv, device=dev)
        K = torch.tensor(_camera_pair(750, 900)[0], dtype=torch.float32, device=dev)
        u = draw_uniforms(cfg, 500, torch.Generator().manual_seed(SEED)).to(dev)
        ms["ransac"], ms["ransac_plain_graph"] = ransac_times(torch, ml, mr, K, nv, u, cfg)
        bounds["ransac"] = ransac_bound(500)
    print(json.dumps({"card": smi, "checkout": os.path.dirname(os.path.abspath(__file__)),
                      "shape": "(b) 1128x1408, D=200, block 17; K4 375x450, chunk 20 "
                               "(394 diagonals a strip); warp 750x900x3 uint8 x 2 -> "
                               "1128x1408, 1128x1408 float32 -> 750x900; RANSAC N=500, "
                               "256 hypotheses of 8, 2 refits on 16", "ms": ms,
                      "bound_ms": bounds}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stereo_reconstruction_tpu_torch.config import MatcherConfig, PipelineConfig
    from stereo_reconstruction_tpu_torch.data.records import StereoPair
    from stereo_reconstruction_tpu_torch.io.mesh_io import read_off
    from stereo_reconstruction_tpu_torch.io.pfm import read_pfm
    from stereo_reconstruction_tpu_torch.kernels import build
    from stereo_reconstruction_tpu_torch.kernels.launch import LAUNCHES
    from stereo_reconstruction_tpu_torch.ops import cuda_block_search as cbs
    from stereo_reconstruction_tpu_torch.ops import cuda_cost_volume as ccv
    from stereo_reconstruction_tpu_torch.ops import cuda_ransac as cransac
    from stereo_reconstruction_tpu_torch.ops import cuda_row_scan as crs
    from stereo_reconstruction_tpu_torch.ops import smoothing
    from stereo_reconstruction_tpu_torch.ops.block_search import block_search_right
    from stereo_reconstruction_tpu_torch.ops.cost_volume import black_pixel_mask
    from stereo_reconstruction_tpu_torch.ops.warp import host_inverse, warp_inverse_map, \
        warp_inverse_maps, warp_perspective
    from stereo_reconstruction_tpu_torch.perceptual import scan as pscan
    from stereo_reconstruction_tpu_torch.pipeline import estimate_pose, run_pair
    from stereo_reconstruction_tpu_torch.rectify.rectifier import disparity_to_original_frame, \
        rectify_pair
    from stereo_reconstruction_tpu_torch.utils.roofline import matcher_bound, scan_bound, \
        warp_bound

    dev = torch.device("cuda", 0)

    def reset_counts():
        LAUNCHES.clear()

    def expected(**k):
        return {"K1": 0, "K1b": 0, "K2": 0, "K3": 0, "K4": 0, "warp": 0, "ransac": 0, **k}

    def counts():
        return {kernel: LAUNCHES[kernel] for kernel in expected()}

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build.load_library()
    print(f"[build] K1, K1b, K2, K3, K4 loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.BUILD_INFO.get('seconds', 0.0):.2f} s)")
    for line in build.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"[build] {line.strip()}")

    # 3. K1, K2 and K1b vs their plain twins on the card
    shapes = {
        "a": dict(h=375, w=450, wl_extra=0, bs=17, min_d=0, max_d=100),
        "b": dict(h=1128, w=1408, wl_extra=0, bs=17, min_d=0, max_d=200),
        "c": dict(h=21, w=40, wl_extra=9, bs=5, min_d=2, max_d=12),
        "d": dict(h=101, w=200, wl_extra=0, bs=9, min_d=1, max_d=31),
    }
    max_err = {"K1": 0.0, "K1b": 0.0, "K2": 0.0, "K3": 0.0, "warp": 0.0, "ransac": 0.0}
    times = {}
    bounds = {}
    for key, s in shapes.items():
        rng = np.random.default_rng(SEED)
        left_np, right_np = _random_stereo(rng, s["h"], s["w"], wl_extra=s["wl_extra"])
        left = torch.from_numpy(left_np).to(dev, torch.float32)
        right = torch.from_numpy(right_np).to(dev, torch.float32)
        args = (left, right, s["bs"], s["min_d"], s["max_d"])
        planes = ccv.matcher_inputs(*args)
        twin = ccv.matcher_inputs_plain(*args)
        torch.cuda.synchronize()
        for name, g, w in zip(("m0", "a0", "c_zero", "diag_up", "diag_lf"), planes, twin):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"K1 != plain at shape ({key}), plane {name}")
            max_err["K1"] = max(max_err["K1"], _max_abs_err(g, w))
        del twin
        k_ms = _median_ms(lambda: ccv.matcher_inputs(*args), torch, CALLS)
        p_ms = _median_ms(lambda: ccv.matcher_inputs_plain(*args), torch)
        times["K1", key] = (k_ms, p_ms)
        bounds["K1", key] = matcher_bound(s, out_planes=5)
        print(f"[kernel] shape ({key}) {s}: 5 planes bit-equal; "
              f"K1 {k_ms:.4f} ms, plain {p_ms:.4f} ms (median of {REPEATS}); "
              f"bound {bounds['K1', key][0]:.4f} ms", flush=True)
        black = black_pixel_mask(right)
        scan = dict(smooth_factor=0.9, d_first=s["min_d"], n_planes=s["max_d"] - s["min_d"])
        got = crs.row_scan(*planes, black, **scan)
        plain = smoothing.smoothed_argmin_from_inputs(*planes, black, **scan)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            raise AssertionError(f"K1b != plain scan at shape ({key}): "
                                 f"{(got != plain).float().mean().item():.3%} of pixels")
        max_err["K1b"] = max(max_err["K1b"], _max_abs_err(got, plain))
        k_ms = _median_ms(lambda: crs.row_scan(*planes, black, **scan), torch, CALLS)
        p_ms = _median_ms(lambda: smoothing.smoothed_argmin_from_inputs(
            *planes, black, **scan), torch)
        times["K1b", key] = (k_ms, p_ms)
        bounds["K1b", key] = scan_bound(s["h"], s["w"])
        print(f"[kernel] shape ({key}): K1b bit-equal to the plain scan on K1's planes; "
              f"K1b {k_ms:.4f} ms, plain {p_ms:.4f} ms (median of {REPEATS}); "
              f"bound {bounds['K1b', key][0]:.4f} ms", flush=True)
        if key == "b":
            # K1b's chain: one 64-column strip alone (H strip-steps, no
            # hand-off) against the canvas (the same steps plus the hand-offs,
            # the fill over its strip boundaries and warps sharing an SM)
            one = [p[:, :64].contiguous() for p in planes]
            one_black = black[:, :64].contiguous()
            one_ms = _median_ms(lambda: crs.row_scan(*one, one_black, **scan), torch, CALLS)
            print(f"[kernel] K1b chain at (b): one 64-column strip {one_ms:.4f} ms "
                  f"({one_ms / s['h'] * 1e3:.4f} us a strip-step); the canvas's "
                  f"{-(-s['w'] // 64)} strips {k_ms:.4f} ms, {k_ms - one_ms:.4f} ms more "
                  f"(hand-offs, fill, warps sharing an SM)", flush=True)
        got = ccv.cost_volume(*args)
        want = ccv.cost_volume_right_ssd(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K2 != plain at shape ({key}): "
                                 f"{(got != want).float().mean().item():.3%} of entries")
        max_err["K2"] = max(max_err["K2"], _max_abs_err(got, want))
        del got, want
        k_ms = _median_ms(lambda: ccv.cost_volume(*args), torch, CALLS)
        p_ms = _median_ms(lambda: ccv.cost_volume_right_ssd(*args), torch)
        times["K2", key] = (k_ms, p_ms)
        bounds["K2", key] = matcher_bound(s, out_planes=s["max_d"] - s["min_d"])
        print(f"[kernel] shape ({key}): volume bit-equal, +inf pattern included; "
              f"K2 {k_ms:.4f} ms, plain {p_ms:.4f} ms (median of {REPEATS}); "
              f"bound {bounds['K2', key][0]:.4f} ms; K2 / K1 "
              f"{k_ms / times['K1', key][0]:.3f}", flush=True)

    # K1b on planted random planes: zeros, sentinels, black pixels and ties,
    # W from 1 to the widest row it takes
    scan_cases = [(9, 1, 0, 0.9, False), (9, 33, 2, 0.9, False), (7, 100, 0, 1.0, True),
                  (5, 1100, 0, 0.9, False), (4, 2100, 2, 0.5, True),
                  (3, crs.max_width(), 1, 0.9, True), (6, 70, 0, 0.0, False)]
    for h, w, d_first, sf, ties in scan_cases:
        cost, black = scan_volume(np.random.default_rng(SEED + w), h, w, 12, ties)
        planes = smoothing.volume_reductions(torch.from_numpy(cost).to(dev), d_first)
        black = torch.from_numpy(black).to(dev)
        scan = dict(smooth_factor=sf, d_first=d_first, n_planes=12)
        got = crs.row_scan(*planes, black, **scan)
        plain = smoothing.smoothed_argmin_from_inputs(*planes, black, **scan)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            raise AssertionError(f"K1b != plain scan on planted planes {h}x{w}, "
                                 f"d_first {d_first}, sf {sf}")
        max_err["K1b"] = max(max_err["K1b"], _max_abs_err(got, plain))
    print(f"[kernel] K1b bit-equal to the plain scan on {len(scan_cases)} planted "
          f"cases (W 1 to {crs.max_width()}, d_first 0-2, sf 0.9 / 1.0 with ties / "
          f"0.5 / 0.0)", flush=True)
    # K1b across its strip boundaries: chain planes, where a wrong case handed
    # from strip to strip changes the pixels to its right
    t0 = time.perf_counter()
    for w in STRIP_WIDTHS:
        for h in (1, 2, 282, 1128):
            ties = (w + h) % 2 == 1
            *planes, black = (torch.from_numpy(a).to(dev) for a in chain_planes(
                np.random.default_rng(SEED + 31 * w + h), h, w, 12, ties))
            scan = dict(smooth_factor=1.0 if ties else 0.9, d_first=w % 3, n_planes=12)
            got = crs.row_scan(*planes, black, **scan)
            plain = smoothing.smoothed_argmin_from_inputs(*planes, black, **scan)
            torch.cuda.synchronize()
            if not torch.equal(got, plain):
                raise AssertionError(f"K1b != plain scan on chain planes {h}x{w}: "
                                     f"{(got != plain).float().mean().item():.3%} of pixels")
            max_err["K1b"] = max(max_err["K1b"], _max_abs_err(got, plain))
    print(f"[kernel] K1b bit-equal to the plain scan on chain planes at W "
          f"{', '.join(map(str, STRIP_WIDTHS))} x H 1, 2, 282, 1128 "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # 4. the matcher (K1 + row scan) against a literal NumPy recurrence
    rng = np.random.default_rng(SEED)
    left_np, right_np = _random_stereo(rng, 28, 40)
    cfg = MatcherConfig(block_size=7, max_disparity=10, backend="pallas")
    got = block_search_right(torch.from_numpy(left_np).to(dev),
                             torch.from_numpy(right_np).to(dev), cfg).cpu().numpy()
    want = _sequential_reference(left_np, right_np, 7, 10)
    if not np.array_equal(got, want):
        raise AssertionError(
            f"matcher != literal recurrence on {np.mean(got != want):.3%} of pixels")
    print("[reference] 28x40 D=10 block 7: K1 matcher equals the literal recurrence")

    # 5. the slice
    rng = np.random.default_rng(SEED)
    left_np, H_lr, F, K = _synthetic_scene(rng)
    right_np = warp_perspective(torch.from_numpy(left_np).to(dev),
                                torch.as_tensor(H_lr, dtype=torch.float32, device=dev),
                                left_np.shape[:2])
    right_np = right_np.round().clamp(0, 255).to(torch.uint8).cpu().numpy()
    gt, mask = _true_disparity(H_lr, F, *left_np.shape[:2])
    pair = StereoPair(left_np, right_np, K.astype(np.float32), K.astype(np.float32),
                      disp_right_gt=gt, mask_right_nocc=mask, name="synthetic")
    slice_pair = pair
    config = PipelineConfig()
    plain_config = config.replace(matcher=MatcherConfig(backend="xla"))

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        res = run_pair(pair, config, output_dir=tmp, write_mesh=True, fixed_F=F,
                       device=dev)
        if counts() != expected(K1=1, K1b=1, warp=2):
            raise AssertionError(f"run_pair launches {counts()}: want one K1, one K1b and "
                                 f"two warps")
        launches["K1"], launches["K1b"] = counts()["K1"], counts()["K1b"]
        launches["warp"] = counts()["warp"]
        peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
        disp = res.disparity
        if disp.shape != (750, 900) or not np.isfinite(disp).all():
            raise AssertionError(f"bad disparity: shape {disp.shape}")
        if not np.array_equal(read_pfm(os.path.join(tmp, "synthetic_disp.pfm")), disp):
            raise AssertionError("staged disparity PFM does not reload equal")
        with open(os.path.join(tmp, "synthetic_pose.json")) as f:
            staged = json.load(f)
        if not np.array_equal(np.asarray(staged["fundamental"]), F):
            raise AssertionError("staged F differs")
        verts, _, faces = read_off(os.path.join(tmp, "synthetic_mesh.off"))
        if verts.shape != (750 * 900, 3) or len(faces) == 0:
            raise AssertionError(f"bad mesh: {verts.shape} vertices, {len(faces)} faces")
        m = res.metrics
        if not m["total_bad_percent"] < MAX_TOTAL_BAD:
            raise AssertionError(f"evaldisp against the true disparity: {m}")
        print(f"[slice] evaldisp vs the scene's true disparity: bad-2.0 "
              f"{m['bad_percent']:.3f}%, invalid {m['invalid_percent']:.3f}%, "
              f"avg err {m['avg_err']:.3f} px over {int(m['n_evaluated'])} px")
        print(f"[slice] run_pair 750x900 D=200: 1 K1, 1 K1b and 2 warp launches, disparity "
              f"finite, "
              f"{len(faces)} mesh faces, artefacts reload; peak {peak_gib:.2f} GiB; "
              f"valid (>0) {np.mean(disp > 0):.4f}", flush=True)

    stage = {"kernel": [], "plain": []}
    disp_plain = None
    for which in ("kernel", "plain", "plain", "kernel", "kernel", "plain", "plain", "kernel"):
        reset_counts()
        r = run_pair(pair, config if which == "kernel" else plain_config,
                     fixed_F=F, device=dev)
        if counts() != expected(K1=int(which == "kernel"), K1b=int(which == "kernel"),
                                warp=2):
            raise AssertionError(f"{which} run_pair: launches {counts()}")
        if which == "kernel" and not np.array_equal(r.disparity, disp):
            raise AssertionError("run_pair is not deterministic")
        if which == "plain":
            disp_plain = r.disparity
        stage[which].append(r.timings)
    agree = float(np.mean(disp == disp_plain))
    if agree < 0.995:
        raise AssertionError(f"kernel vs plain disparity agreement {agree:.4%} < 99.5%")
    print(f"[slice] kernel vs plain backend disparity agreement {agree:.6f}")
    for which in ("kernel", "plain"):
        runs = stage[which][1:]        # first run of each is the warm-up
        med = {k: statistics.median(t[k] for t in runs) * 1e3
               for k in ("rectify", "disparity", "recon")}
        print(f"[slice] {which} backend stage ms (median of {len(runs)}): "
              + ", ".join(f"{k} {v:.2f}" for k, v in med.items()), flush=True)

    # where the disparity stage goes, on the slice's own rectified inputs
    imgs = [torch.from_numpy(x).to(dev) for x in (left_np, right_np)]
    reset_counts()
    rect = rectify_pair(*imgs, F)
    if counts() != expected(warp=1):
        raise AssertionError(f"rectify_pair launches {counts()}: want one warp")
    planes = ccv.matcher_inputs(rect.left, rect.right, 17, 0, 200)
    black = black_pixel_mask(rect.right)
    scan = dict(smooth_factor=0.9, d_first=0, n_planes=200)
    got = crs.row_scan(*planes, black, **scan)
    plain = smoothing.smoothed_argmin_from_inputs(*planes, black, **scan)
    torch.cuda.synchronize()
    if not torch.equal(got, plain):
        raise AssertionError("K1b != plain scan on the slice's canvas planes")
    max_err["K1b"] = max(max_err["K1b"], _max_abs_err(got, plain))
    scan_ms = _median_ms(lambda: crs.row_scan(*planes, black, **scan), torch, CALLS)
    plain_scan_ms = _median_ms(
        lambda: smoothing.smoothed_argmin_from_inputs(*planes, black, **scan), torch)
    k1_rect_ms = _median_ms(lambda: ccv.matcher_inputs(rect.left, rect.right, 17, 0, 200),
                            torch, CALLS)
    print(f"[slice] disparity stage parts on the {tuple(rect.canvas)} canvas: "
          f"K1 {k1_rect_ms:.4f} ms, K1b {scan_ms:.4f} ms (bit-equal to the plain scan, "
          f"{plain_scan_ms:.2f} ms)", flush=True)

    # the warp kernel on the slice's own pair against its plain twin on the
    # card: both 750x900x3 images onto the canvas (bilinear, one launch),
    # and the canvas's disparity back to 750x900 (nearest)
    homs = rect.homographies
    maps = host_inverse(np.stack([homs.H_left, homs.H_right]))
    back = host_inverse(host_inverse(homs.H_right))
    maps_d, back_d = maps.to(dev), back.to(dev)
    reset_counts()
    back_k = disparity_to_original_frame(got, homs.H_right, (750, 900))
    if counts() != expected(warp=1):
        raise AssertionError(f"back-warp launches {counts()}: want one warp")
    twins = [("left", rect.left, warp_inverse_map(imgs[0], maps_d[0], rect.canvas)),
             ("right", rect.right, warp_inverse_map(imgs[1], maps_d[1], rect.canvas)),
             ("back-warp", back_k, warp_inverse_map(got, back_d, (750, 900), "nearest"))]
    torch.cuda.synchronize()
    for name, g, w in twins:
        if g.shape != w.shape or not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            raise AssertionError(f"warp kernel != plain twin on the slice's {name}: "
                                 f"{(g != w).float().mean().item():.3%} of values")
        max_err["warp"] = max(max_err["warp"], _max_abs_err(g, w))
    del twins
    times["warp", "rectify"] = (
        _median_queued_ms(lambda: warp_inverse_maps(imgs, maps, rect.canvas), torch),
        _median_queued_ms(lambda: [warp_inverse_map(i, m, rect.canvas)
                                   for i, m in zip(imgs, maps_d)], torch))
    times["warp", "back"] = (
        _median_queued_ms(lambda: warp_inverse_maps([got], back[None], (750, 900), "nearest"),
                          torch),
        _median_queued_ms(lambda: warp_inverse_map(got, back_d, (750, 900), "nearest"), torch))
    bounds["warp", "rectify"] = warp_bound(750, 900, 3, 1, *rect.canvas, images=2)
    bounds["warp", "back"] = warp_bound(*rect.canvas, 1, 4, 750, 900, nearest=True)
    print(f"[slice] warp kernel bit-equal to its plain twin on the card: both 750x900x3 "
          f"images onto the {tuple(rect.canvas)} canvas (one launch) "
          f"{times['warp', 'rectify'][0]:.4f} ms, plain {times['warp', 'rectify'][1]:.4f} ms, "
          f"bound {bounds['warp', 'rectify'][0]:.4f} ms; the back-warp to 750x900 "
          f"{times['warp', 'back'][0]:.4f} ms, plain {times['warp', 'back'][1]:.4f} ms, bound "
          f"{bounds['warp', 'back'][0]:.4f} ms (median of {REPEATS}, queued)", flush=True)

    # 6. K2's path on the same canvas, as tools/tpu_validate.py runs it
    reset_counts()
    volume = ccv.cost_volume(rect.left, rect.right, 17, 0, 200)
    reductions = smoothing.volume_reductions(volume, 0)
    del volume
    disp_k2 = crs.row_scan(*reductions, black, **scan)
    torch.cuda.synchronize()
    if counts() != expected(K1b=1, K2=1):
        raise AssertionError(f"K2 path launches {counts()}: want one K2 and one K1b")
    launches["K2"] = counts()["K2"]
    if disp_k2.shape != tuple(rect.canvas) or not torch.isfinite(disp_k2).all():
        raise AssertionError(f"K2 path: bad disparity {tuple(disp_k2.shape)}")
    for name, g, w in zip(("m0", "a0", "c_zero", "diag_up", "diag_lf"), reductions, planes):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(f"volume_reductions(K2) != K1 on the canvas, plane {name}")
    disp_k1 = block_search_right(rect.left, rect.right, MatcherConfig())
    if not torch.equal(disp_k2, disp_k1):
        raise AssertionError("K2 route disparity != K1 route disparity on the canvas")
    print(f"[K2 path] {tuple(rect.canvas)} canvas D=200: volume_reductions(K2) equal "
          f"K1's 5 planes and their K1b disparity equals the K1 route, "
          f"bit for bit", flush=True)

    # 7. K3 vs its plain twin on integer-valued pairs
    base = dict(wl_extra=0, min_d=0, seed=SEED, sf=0.9)
    k3_cases = [dict(base, h=21, w=40, wl_extra=9, bs=5, min_d=2, max_d=12, tw=512,
                     iters=2, mode="reference")]
    k3_cases += [dict(base, h=20, w=90, bs=5, max_d=8, tw=64, iters=iters, mode=mode)
                 for iters in (1, 2, 3) for mode in ("reference", "intended", "none")]
    k3_cases += [
        dict(base, h=64, w=1100, bs=17, max_d=64, tw=512, iters=2, mode="reference"),
        # smooth_factor 0: +inf * 0 is NaN, which wins the minimum (column 37)
        *(dict(base, h=20, w=40, bs=5, max_d=30, tw=64, iters=2, mode="intended",
               sf=0.0, seed=seed) for seed in (0, 1, 2)),
        # tiles narrower than the sweep count: each boundary chains to the last
        dict(base, h=20, w=90, bs=5, max_d=8, tw=2, iters=3, mode="intended"),
        # shape (d): the bottom tile's band ends at row H-2
        dict(base, h=101, w=200, bs=9, min_d=1, max_d=31, tw=64, iters=2,
             mode="reference"),
        # wider than 4096: the row chain has no width limit
        dict(base, h=8, w=4200, bs=5, max_d=16, tw=1024, iters=2, mode="reference"),
    ]
    for c in k3_cases:
        rng = np.random.default_rng(c["seed"])
        left_np, right_np = _random_stereo(rng, c["h"], c["w"], wl_extra=c["wl_extra"])
        left = torch.from_numpy(left_np).to(dev, torch.float32)
        right = torch.from_numpy(right_np).to(dev, torch.float32)
        cfg = MatcherConfig(block_size=c["bs"], min_disparity=c["min_d"],
                            max_disparity=c["max_d"], row_smooth_iters=c["iters"],
                            smooth_factor=c["sf"])
        got = cbs.block_search_fused(left, right, cfg, c["tw"], c["mode"])
        want = cbs.block_search_fused_plain(left, right, cfg, c["tw"], c["mode"])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K3 != plain on {c}: "
                                 f"{(got != want).float().mean().item():.3%} of pixels")
        if c["sf"] == 0.0 and not bool((got[:, 37] == -37).all()):
            raise AssertionError(f"K3 at smooth_factor 0: column 37 is not -37 on {c}")
        max_err["K3"] = max(max_err["K3"], _max_abs_err(got, want))
    print(f"[kernel] K3 bit-equal to its twin on {len(k3_cases)} integer cases "
          f"(tiles 1-3 and 2 px wide, iters 1-3, all smooth modes, min_d 2, "
          f"smooth_factor 0, shape (d), W 4200)", flush=True)

    # 8. K3's path at full width on the canvas
    cfg = MatcherConfig()                      # block 17, D=200, 2 sweeps
    reset_counts()
    disp_k3 = cbs.block_search_fused(rect.left, rect.right, cfg)
    torch.cuda.synchronize()
    if counts() != expected(K3=1):
        raise AssertionError(f"K3 path launches {counts()}: want one K3 only")
    launches["K3"] = counts()["K3"]
    if disp_k3.shape != tuple(rect.canvas) or not torch.isfinite(disp_k3).all():
        raise AssertionError(f"K3 path: bad disparity {tuple(disp_k3.shape)}")
    if not torch.equal(cbs.block_search_fused(rect.left, rect.right, cfg), disp_k3):
        raise AssertionError("K3 differs between two runs on the canvas")
    twin = cbs.block_search_fused_plain(rect.left, rect.right, cfg)
    agree_twin = float((disp_k3 == twin).double().mean())
    agree_exact = float((disp_k3 == disp_k1).double().mean())
    print(f"[K3 path] {tuple(rect.canvas)} canvas D=200 tile 512 "
          f"({-(-rect.canvas[1] // 512)} tiles): equal to itself over two runs; "
          f"agreement {agree_twin:.6f} with its twin, {agree_exact:.6f} with the "
          f"exact K1 route", flush=True)
    if agree_twin < 0.995:
        raise AssertionError(f"K3 vs twin agreement {agree_twin:.4%} < 99.5%")
    if agree_exact < 0.98:
        raise AssertionError(f"K3 vs exact route agreement {agree_exact:.4%} < 98%")
    k3_ms = _median_ms(lambda: cbs.block_search_fused(rect.left, rect.right, cfg), torch)
    bounds["K3", "canvas"] = matcher_bound(
        dict(h=rect.canvas[0], w=rect.canvas[1], wl_extra=0, bs=17, min_d=0, max_d=200),
        out_planes=1)
    k3_plain_ms = _median_ms(
        lambda: cbs.block_search_fused_plain(rect.left, rect.right, cfg), torch)
    times["K3", "canvas"] = (k3_ms, k3_plain_ms)
    exact_ms = k1_rect_ms + scan_ms
    print(f"[K3 path] K3 {k3_ms:.4f} ms, plain twin {k3_plain_ms:.2f} ms "
          f"(median of {REPEATS}); the exact route on this canvas: K1 "
          f"{k1_rect_ms:.4f} ms + K1b {scan_ms:.4f} ms; K3 / (K1 + K1b) "
          f"{k3_ms / exact_ms:.3f}", flush=True)
    split = _kernel_split(lambda: cbs.block_search_fused(rect.left, rect.right, cfg), torch)
    if split:
        rows_ms = split.get("block_search_rows_kernel", 0.0)
        print("[K3 path] profiled K3 call, device ms by kernel: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; row chain {1e3 * rows_ms / rect.canvas[0]:.3f} us per row", flush=True)
    else:
        print("[K3 path] K3 phase split not measured (the profiler saw no device work)")

    # 9. the whole chain, run_pair() with no F: the pose stage finds F
    rng = np.random.default_rng(SEED)
    left_np, right_np, K, R_true, T_true, F_true, src = nonplanar_scene(rng)
    gt, mask = nonplanar_disparity(src, F_true)
    pair = StereoPair(left_np, right_np, K.astype(np.float32), K.astype(np.float32),
                      disp_right_gt=gt, mask_right_nocc=mask, name="nonplanar")
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        res = run_pair(pair, config, output_dir=tmp, write_mesh=True, device=dev)
        # the first posed call captures the pose stage's graphs, launching
        # RANSAC once more to feed the refine graph's capture (pose/graphs.py)
        if counts() != expected(K1=1, K1b=1, warp=2, ransac=4):
            raise AssertionError(f"run_pair() launches {counts()}: want one K1, one K1b, "
                                 f"two warps and four RANSAC (two and the capture's two)")
        pose = res.pose
        P = pose.pose.cpu().numpy()
        rot, trans = pose_angles(P, R_true, T_true)
        m = res.metrics
        print(f"[pose] run_pair() 750x900: valid {bool(pose.valid)}, pose_ok "
              f"{m['pose_ok']}, enough_points {bool(pose.enough_points)}, "
              f"{int(pose.num_inliers)} inliers, reprojection error 8pt "
              f"{m['reproj_error_8pt']:.4f} px, BA {m['reproj_error_ba']:.4f} px; "
              f"rotation {rot:.4f} deg and translation direction {trans:.4f} deg "
              f"from the truth", flush=True)
        if not (bool(pose.valid) and m["pose_ok"] == 1.0 and bool(pose.enough_points)):
            raise AssertionError(f"pose stage failed: {m}")
        if not (rot < 0.5 and trans < 2.0 and m["reproj_error_ba"] < 1.0):
            raise AssertionError(f"pose off: {rot} deg, {trans} deg, {m}")
        if res.disparity.shape != (750, 900) or not np.isfinite(res.disparity).all():
            raise AssertionError(f"bad disparity: shape {res.disparity.shape}")
        if not m["total_bad_percent"] < MAX_TOTAL_BAD:
            raise AssertionError(f"evaldisp against the true disparity: {m}")
        print(f"[pose] evaldisp vs the scene's true disparity: bad-2.0 "
              f"{m['bad_percent']:.3f}%, invalid {m['invalid_percent']:.3f}%, "
              f"avg err {m['avg_err']:.3f} px over {int(m['n_evaluated'])} px")
        with open(os.path.join(tmp, "nonplanar_pose.json")) as f:
            staged = json.load(f)
        if not np.array_equal(np.asarray(staged["pose"], np.float32), P):
            raise AssertionError("staged 4x4 pose does not reload equal")
        verts, _, faces = read_off(os.path.join(tmp, "nonplanar_mesh.off"))
        if verts.shape != (750 * 900, 3) or len(faces) == 0:
            raise AssertionError(f"bad mesh: {verts.shape} vertices, {len(faces)} faces")

    runs = []
    for _ in range(3):
        reset_counts()
        r = run_pair(pair, config, device=dev)
        if counts() != expected(K1=1, K1b=1, warp=2, ransac=2):
            raise AssertionError(f"run_pair() launches {counts()}")
        launches["ransac"] = counts()["ransac"]
        if not torch.equal(r.pose.pose, pose.pose):
            raise AssertionError("run_pair() pose is not deterministic")
        runs.append(r.timings)
    med = {k: statistics.median(t[k] for t in runs) * 1e3
           for k in ("pose", "rectify", "disparity", "recon")}

    # the RANSAC kernel on this run's matches and draws (recomputed, and shown
    # to be the run's by its RANSAC pose) against its pinned twin
    from ransac_twin import card_kernel, compare as compare_ransac
    from stereo_reconstruction_tpu_torch.ops.features import Keypoints, \
        detect_and_describe_batch
    from stereo_reconstruction_tpu_torch.ops.matching import match_descriptors, valid_first
    from stereo_reconstruction_tpu_torch.pose.ransac import draw_uniforms
    from stereo_reconstruction_tpu_torch.utils.roofline import ransac_bound

    images = torch.stack([torch.from_numpy(left_np), torch.from_numpy(right_np)]).to(dev)
    kp = detect_and_describe_batch(images, config.frontend)
    ml, mr, nv = valid_first(match_descriptors(Keypoints(*(x[0] for x in kp)),
                                               Keypoints(*(x[1] for x in kp)), config.frontend))
    u = draw_uniforms(config.ransac, ml.shape[-1],
                      torch.Generator().manual_seed(config.seed)).to(dev)
    Kd = torch.as_tensor(K, dtype=torch.float32, device=dev)
    got, want, dev_r = compare_ransac(card_kernel, ml, mr, nv, config.ransac, Kd, u, dev)
    if not torch.equal(got.pose[0], pose.pose_ransac.cpu()):
        raise AssertionError("the RANSAC kernel on the recomputed matches does not give the "
                             "run's RANSAC pose")
    max_err["ransac"] = max(_max_abs_err(getattr(got, f)[0], getattr(want, f))
                            for f in got._fields if getattr(want, f).dtype.is_floating_point)
    times["ransac", "pose"] = ransac_times(torch, ml, mr, Kd, nv, u, config.ransac)
    bounds["ransac", "pose"] = ransac_bound(ml.shape[-1], config.ransac.num_hypotheses,
                                           config.ransac.sample_size,
                                           cransac.support_of(config.ransac, ml.shape[-1]),
                                           config.ransac.refine_rounds)
    print(f"[pose] {smi}: RANSAC kernel on the run's {ml.shape[-1]} matches ({int(nv)} "
          f"valid), {config.ransac.num_hypotheses} hypotheses: its twin's samples, winner "
          f"and fit; largest deviations "
          + ", ".join(f"{k} {v:.3g}" for k, v in dev_r.items())
          + f"; result max |err| {max_err['ransac']:.3g}; kernel "
          f"{times['ransac', 'pose'][0]:.4f} ms, twin's graph {times['ransac', 'pose'][1]:.2f} "
          f"ms, bound {bounds['ransac', 'pose'][0] * 1e3:.4f} us (median of {REPEATS}, queued)",
          flush=True)
    print(f"[pose] {smi}: run_pair() stage ms (median of 3 after the first run): "
          + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
          + "; the same pose every run", flush=True)
    cpu_pose = estimate_pose(pair, config, device="cpu")
    d_rot, d_trans = pose_angles(P, cpu_pose.pose[:3, :3].numpy(),
                                 cpu_pose.pose[:3, 3].numpy())
    print(f"[pose] card vs the port on the CPU, same draws: rotation {d_rot:.5f} deg, "
          f"translation direction {d_trans:.5f} deg", flush=True)
    if not (d_rot < 0.05 and d_trans < 0.2):
        raise AssertionError(f"card and CPU poses differ: {d_rot} deg, {d_trans} deg")
    kernels, device_ms, wall_ms = _pose_profile(
        lambda: estimate_pose(pair, config, device=dev), torch)
    print(f"[pose] profiled estimate_pose: {wall_ms:.1f} ms wall, "
          + (f"{kernels} device kernels, {device_ms:.1f} ms device time "
             f"({100 * device_ms / wall_ms:.1f}% busy)" if kernels else
             "device time not measured (the profiler saw no device work)"), flush=True)

    # 10. the batched main path
    ctx = dict(torch=torch, dev=dev, config=config, smi=smi, counts=counts,
               reset_counts=reset_counts, expected=expected)
    pairs, batch_launches = batch_phase(**ctx)
    launches.update(batch_launches)

    # 11. the command line
    cli_phase(torch, dev, config, pairs[0])

    # 12. the dense variants, 13. the uncalibrated path
    variants_phase(torch, dev, smi, rect, slice_pair, F, pairs[0], counts, reset_counts,
                   expected)
    uncalibrated_phase(torch, dev, smi, counts, reset_counts, expected)

    # 14. the perceptual matcher and K4
    k4 = perceptual_phase(torch, dev, smi, counts, reset_counts, expected)
    launches["K4"], max_err["K4"], times["K4", "scene"], bounds["K4", "scene"] = k4

    # 15. the multi-device layer
    sharded_phase(torch, dev, smi, counts, reset_counts, expected)

    print(f"[smoke] all phases in {time.perf_counter() - t_start:.1f} s", flush=True)
    csrc = "stereo_reconstruction_tpu_torch/csrc/"
    kernels = [
        ("K1", "fused matcher inputs (left_layout_kernel + matcher_inputs_kernel)",
         csrc + "matcher_inputs.cuh",
         "stereo_reconstruction_tpu/ops/pallas_cost_volume.py:68", ("K1", "b")),
        ("K1b", "exact smoothing row scan", csrc + "row_scan.cuh",
         "stereo_reconstruction_tpu/ops/smoothing.py:125", ("K1b", "b")),
        ("K2", "cost volume", csrc + "cost_volume.cuh",
         "stereo_reconstruction_tpu/ops/pallas_cost_volume.py:68", ("K2", "b")),
        ("K3", "fused block search", csrc + "block_search.cuh",
         "stereo_reconstruction_tpu/ops/pallas_block_search.py:48", ("K3", "canvas")),
        ("K4", "perceptual windowed smoother", csrc + "perceptual_scan.cuh",
         "stereo_reconstruction_tpu/perceptual/cost.py:293", ("K4", "scene")),
        ("warp", "perspective warp, both rectifying warps", csrc + "warp.cuh",
         "stereo_reconstruction_tpu/ops/warp.py:41", ("warp", "rectify")),
        ("warp", "perspective warp, the disparity back-warp", csrc + "warp.cuh",
         "stereo_reconstruction_tpu/ops/warp.py:41", ("warp", "back")),
        ("ransac", "RANSAC: hypotheses, scores, winner and refits", csrc + "ransac.cuh",
         None, ("ransac", "pose")),       # not a TPU kernel: JAX's RANSAC is plain jnp
    ]
    at = {"b": "1128x1408 canvas, D=200, block 17", "canvas": "1128x1408 canvas, D=200, block 17",
          "scene": "375x450, D=100, window 17, chunk 20 (the windowed volume)",
          "rectify": "both uint8 750x900x3 images -> 1128x1408 canvas, bilinear, one launch",
          "back": "1128x1408 float32 disparity -> 750x900, nearest",
          "pose": "the posed run_pair's 500 matches, 256 hypotheses of 8, 2 refits on 16"}
    print(json.dumps({"kernels": [{
        "name": f"{k} {name}",
        "route": "cuda",
        "source": src,
        "replaces": replaces,
        "launches": launches[k],
        "max_abs_err": max_err[k],
        "ms": times[key][0],
        "plain_ms": times[key][1],
        "bound_ms": bounds[key][0],
        "bound_by": bounds[key][1],
        "library_ms": None,             # no single PyTorch call computes it
        "at": at[key[1]],
    } for k, name, src, replaces, key in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(time_kernels(sys.argv[2:]) if sys.argv[1:2] == ["--time-kernels"] else main())
