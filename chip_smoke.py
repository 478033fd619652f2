#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives ``stereo_reconstruction_tpu_torch`` on ``cuda:0`` and fails (exit
code 1, no result line) if anything is off:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: K1 (``csrc/matcher_inputs.cu``), K1b (``csrc/row_scan.cu``),
   K2 (``csrc/cost_volume.cu``) and K3 (``csrc/block_search.cu``) with one
   ``nvcc`` each for ``sm_90a``, all started together;
3. K1, K2 and K1b against their plain PyTorch twins on the card at four
   shapes — (a) 375x450, D=100, block 17 (MiddEval3 trainingQ), (b) the
   1128x1408 rectified canvas of a 750x900 pair, D=200, block 17 (the
   reference's operating point, main.cpp:40), (c) H=21, W=40, WL=49,
   min_d=2, block 5 — on integer-valued pairs, where K1's five planes,
   K2's volume (+inf pattern included) and K1b's disparity from K1's
   planes must be bit equal; (d) 101x200, D=30, min_d=1, block 9, puts an
   interior K1 tile's band at the image bottom, where the overrun slots of
   its band loads must load nothing; then K1b on planted random planes (W
   from 1 to 4096); median kernel and plain ms over 5 timed runs after a
   warm-up;
4. the matcher against a literal NumPy recurrence on a small pair;
5. the slice: ``run_pair(fixed_F=F)`` on a synthetic 750x900 pair with
   a known F at the default config (block 17, D=200, outlier kernel 500),
   with exactly one K1 and one K1b launch and no K2 or K3 launch per call,
   the three staged artefacts, ``evaldisp`` against the scene's true
   disparity, and >= 99.5% disparity agreement with the plain backend;
   median stage times over 3 runs after a warm-up; K1b bit-equal to the
   plain scan on the slice's own K1 planes;
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
   RANSAC hypotheses, BA over 60 points, D=200, block 17): exactly one K1
   and one K1b launch and no K2 or K3 launch; a valid pose with enough points,
   ``pose_ok``, rotation < 0.5 deg and translation direction < 2 deg from
   the truth, BA reprojection error < 1 px; evaldisp total-bad < 20%
   against the true disparity; the 4x4 pose staged and reloaded; the same
   pose on three more runs, whose median stage times are printed; the
   port's CPU ``estimate_pose`` (same draws) within 0.05 deg in rotation
   and 0.2 deg in translation direction; a profile of the pose stage.

Each path (5, 6, 8, 9) runs with every launch count set to 0 just before it
and read just after; the launches made to compare a kernel with its twin
are not counted. The line before the last is ``{"kernels": [...]}``, each
kernel with its bound (the larger of its bytes over 3.35 TB/s and its
float32 operations over 67 TFLOP/s, counted for this run's inputs); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
REPEATS = 5
# kernel launches per timed sample (one host call would time the enqueue)
CALLS = 10
# the H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
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


def _bound(nbytes, ops):
    """(ms, what binds): the larger of the bytes over the card's memory rate
    and the float32 operations over its peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _matcher_bound(s, out_planes):
    """Least time of a cost kernel at shape ``s`` with ``out_planes`` (H, W)
    float32 outputs: both images read once, the outputs written once, and
    per (pixel, plane) with a candidate 9 operations of squared difference,
    2 x 2hbs window adds, a sqrt, a multiply and a compare. The bound is
    the function's: K1's left layout pass (12 B x H x WLp written to its
    own scratch and read back) is left out."""
    h, w, hbs = s["h"], s["w"], (s["bs"] - 1) // 2
    wl, min_d, d = w + s["wl_extra"], s["min_d"], s["max_d"] - s["min_d"]
    pairs = 0
    if hbs > 0 and h > 1 and w > 1:
        reach = np.minimum(w - 1, np.arange(w) + hbs)    # x + min(W-1-x, hbs)
        pairs = h * int(np.clip(wl - reach - min_d, 0, d).sum())
    nbytes = 4 * 3 * h * (w + wl) + 4 * out_planes * h * w
    return _bound(nbytes, pairs * (9 + 4 * hbs + 3))


def _scan_bound(h, w):
    """Least time of K1b on an (h, w) row: five planes and the mask read,
    the disparity written (25 bytes a pixel), and ~30 float32 operations a
    pixel (the up product, three candidates of two products and four
    compares each). Neither binds in practice: the h dependent rows do."""
    return _bound(25 * h * w, 30 * h * w)


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


def _pose_profile(estimate, torch):
    """(device kernels launched, device ms, wall ms) of one call, from
    torch.profiler; None for the device numbers if it saw no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        estimate()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, device_us = 0, 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels += e.count
            device_us += getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
    if kernels == 0:
        return None, None, wall_ms
    return kernels, device_us / 1e3, wall_ms


def _kernel_split(call, torch):
    """Device ms of one call by kernel name (torch.profiler), {} if the
    profiler saw no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
            name = next((k for k in ("left_layout_kernel", "block_search_costs_kernel",
                                     "block_search_rows_kernel") if k in e.key), e.key[:40])
            split[name] = split.get(name, 0.0) + us / 1e3
    return split


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stereo_reconstruction_tpu_torch.config import MatcherConfig, PipelineConfig
    from stereo_reconstruction_tpu_torch.data.records import StereoPair
    from stereo_reconstruction_tpu_torch.io.mesh_io import read_off
    from stereo_reconstruction_tpu_torch.io.pfm import read_pfm
    from stereo_reconstruction_tpu_torch.kernels import build
    from stereo_reconstruction_tpu_torch.ops import cuda_block_search as cbs
    from stereo_reconstruction_tpu_torch.ops import cuda_cost_volume as ccv
    from stereo_reconstruction_tpu_torch.ops import cuda_row_scan as crs
    from stereo_reconstruction_tpu_torch.ops import smoothing
    from stereo_reconstruction_tpu_torch.ops.block_search import block_search_right
    from stereo_reconstruction_tpu_torch.ops.cost_volume import black_pixel_mask
    from stereo_reconstruction_tpu_torch.ops.warp import warp_perspective
    from stereo_reconstruction_tpu_torch.pipeline import estimate_pose, run_pair
    from stereo_reconstruction_tpu_torch.rectify.rectifier import rectify_pair

    dev = torch.device("cuda", 0)

    def reset_counts():
        ccv.LAUNCHES = crs.LAUNCHES = ccv.VOLUME_LAUNCHES = cbs.LAUNCHES = 0

    def counts():
        return {"K1": ccv.LAUNCHES, "K1b": crs.LAUNCHES, "K2": ccv.VOLUME_LAUNCHES,
                "K3": cbs.LAUNCHES}

    def expected(**k):
        return {"K1": 0, "K1b": 0, "K2": 0, "K3": 0, **k}

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
    print(f"[build] K1, K1b, K2, K3 loaded in {time.perf_counter() - t0:.2f} s "
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
    max_err = {"K1": 0.0, "K1b": 0.0, "K2": 0.0, "K3": 0.0}
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
        bounds["K1", key] = _matcher_bound(s, out_planes=5)
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
        bounds["K1b", key] = _scan_bound(s["h"], s["w"])
        print(f"[kernel] shape ({key}): K1b bit-equal to the plain scan on K1's planes; "
              f"K1b {k_ms:.4f} ms, plain {p_ms:.4f} ms (median of {REPEATS}); "
              f"bound {bounds['K1b', key][0]:.4f} ms", flush=True)
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
        bounds["K2", key] = _matcher_bound(s, out_planes=s["max_d"] - s["min_d"])
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
    config = PipelineConfig()
    plain_config = config.replace(matcher=MatcherConfig(backend="xla"))

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        res = run_pair(pair, config, output_dir=tmp, write_mesh=True, fixed_F=F,
                       device=dev)
        if counts() != expected(K1=1, K1b=1):
            raise AssertionError(f"run_pair launches {counts()}: want one K1 and one K1b")
        launches["K1"], launches["K1b"] = counts()["K1"], counts()["K1b"]
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
        print(f"[slice] run_pair 750x900 D=200: 1 K1 and 1 K1b launch, disparity finite, "
              f"{len(faces)} mesh faces, artefacts reload; peak {peak_gib:.2f} GiB; "
              f"valid (>0) {np.mean(disp > 0):.4f}", flush=True)

    stage = {"kernel": [], "plain": []}
    disp_plain = None
    for which in ("kernel", "plain", "plain", "kernel", "kernel", "plain", "plain", "kernel"):
        reset_counts()
        r = run_pair(pair, config if which == "kernel" else plain_config,
                     fixed_F=F, device=dev)
        if counts() != expected(K1=int(which == "kernel"), K1b=int(which == "kernel")):
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
    rect = rectify_pair(torch.from_numpy(left_np).to(dev),
                        torch.from_numpy(right_np).to(dev), F)
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
    bounds["K3", "canvas"] = _matcher_bound(
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
        if counts() != expected(K1=1, K1b=1):
            raise AssertionError(f"run_pair() launches {counts()}: want one K1 and one K1b")
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
        if counts() != expected(K1=1, K1b=1):
            raise AssertionError(f"run_pair() launches {counts()}")
        if not torch.equal(r.pose.pose, pose.pose):
            raise AssertionError("run_pair() pose is not deterministic")
        runs.append(r.timings)
    med = {k: statistics.median(t[k] for t in runs) * 1e3
           for k in ("pose", "rectify", "disparity", "recon")}
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

    csrc = "stereo_reconstruction_tpu_torch/csrc/"
    kernels = [
        ("K1", "fused matcher inputs (left_layout_kernel + matcher_inputs_kernel)",
         csrc + "matcher_inputs.cuh",
         "stereo_reconstruction_tpu/ops/pallas_cost_volume.py:68", ("K1", "b")),
        ("K1b", "exact smoothing row scan", csrc + "row_scan.cuh",
         "stereo_reconstruction_tpu/ops/smoothing.py:125", ("K1b", "b")),
        ("K2", "cost volume", csrc + "cost_volume.cuh",
         "stereo_reconstruction_tpu/ops/pallas_cost_volume.py:68", ("K2", "b")),
        ("K3", "fused block search",
         "stereo_reconstruction_tpu_torch/csrc/block_search.cuh",
         "stereo_reconstruction_tpu/ops/pallas_block_search.py:48", ("K3", "canvas")),
    ]
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
        "at": "1128x1408 canvas, D=200, block 17",
    } for k, name, src, replaces, key in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
