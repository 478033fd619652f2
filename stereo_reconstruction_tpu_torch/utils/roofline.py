"""The least time the H100 can take for a kernel's work: the roofline
bounds of the port's kernels.

Port of ``stereo_reconstruction_tpu/utils/roofline.py``, whose model is
the TPU v5e's (its HBM, MXU and VPU peaks and the Pallas kernel's
128-lane tiling). This one is the NVIDIA H100 SXM's, from its data sheet:
3.35 TB/s of HBM and 67 TFLOP/s of float32 (PERF.md §6). A kernel's bound
is the larger of two times: the bytes its function must move (each input
read once, each output written once) over the memory rate, and the
float32 operations it does on this call's inputs over the peak rate.
The bound is the function's, not the kernel's: scratch a kernel keeps for
itself (K1's left layout, K3's cost volume) is not in it.

``chip_smoke.py`` prints these bounds in its ``{"kernels": [...]}`` line
and ``report`` turns a measured time into a roofline record.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

PEAK_BYTES = 3.35e12     # HBM3 bytes/s
PEAK_FP32 = 67e12        # float32 FLOP/s


def bound(nbytes: float, ops: float):
    """(ms, what binds): the larger of the bytes over the memory rate and
    the float32 operations over the peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matcher_bytes_ops(s: Dict, out_planes: int):
    """(bytes, operations) of a window-cost kernel (K1, K2, K3's cost pass)
    at shape ``s`` = dict(h, w, wl_extra, bs, min_d, max_d) with
    ``out_planes`` (H, W) float32 outputs: both images read once, the
    outputs written once, and per (pixel, plane) with a candidate 9
    operations of squared difference, 2 x 2hbs window adds, a sqrt, a
    multiply and a compare."""
    h, w, hbs = s["h"], s["w"], (s["bs"] - 1) // 2
    wl, min_d, d = w + s["wl_extra"], s["min_d"], s["max_d"] - s["min_d"]
    pairs = 0
    if hbs > 0 and h > 1 and w > 1:
        reach = np.minimum(w - 1, np.arange(w) + hbs)    # x + min(W-1-x, hbs)
        pairs = h * int(np.clip(wl - reach - min_d, 0, d).sum())
    return 4 * 3 * h * (w + wl) + 4 * out_planes * h * w, pairs * (9 + 4 * hbs + 3)


def matcher_bound(s: Dict, out_planes: int):
    """``bound`` of a window-cost kernel (``matcher_bytes_ops``)."""
    return bound(*matcher_bytes_ops(s, out_planes))


def scan_bytes_ops(h: int, w: int):
    """(bytes, operations) of K1b on an (h, w) image: five planes and the
    mask read, the disparity written (25 bytes a pixel), ~30 float32
    operations a pixel (the up product, three candidates of two products
    and four compares each)."""
    return 25 * h * w, 30 * h * w


def scan_bound(h: int, w: int):
    """``bound`` of K1b. Neither binds in practice: the h dependent rows do."""
    return bound(*scan_bytes_ops(h, w))


def window_scan_bound(h: int, d: int, w: int):
    """``bound`` of K4 on an (h, d, w) volume: the volume and the weight
    table read once, the indices written once, 3 float32 operations an
    entry (two products and a compare). Neither binds in practice: each
    strip's chain of dependent argmins does."""
    return bound(4 * (h * d * w + d + 1 + h * w), 3 * h * d * w)


def warp_bound(h: int, w: int, channels: int, src_bytes: int, h_out: int, w_out: int,
               images: int = 1, nearest: bool = False):
    """``bound`` of the warp kernel on ``images`` (h, w, channels) sources
    of ``src_bytes`` a value into (h_out, w_out, channels) float32: each
    source read once, each output written once; per output pixel 14
    float32 operations of the map, then bilinear 6 + 15 a channel (the
    floors and weights; four masked samples, eight products, three adds)
    or nearest 2 + 1 a channel (the roundings; one masked sample)."""
    per_pixel = 16 + channels if nearest else 20 + 15 * channels
    return bound(images * (h * w * channels * src_bytes + 4 * h_out * w_out * channels),
                 images * h_out * w_out * per_pixel)


def eight_point_ops(m: int) -> int:
    """Float32 operations of one eight-point solve on m points, as the RANSAC
    kernel and its twin do it: normalising both sides (14 a point), chi and
    chi^T chi (9 products a point, then 45 entries of a product and an add a
    point), 6 sweeps of the 9x9 Jacobi's 36 rotations (14 for c and s; rows
    and columns p, q of A and columns p, q of V, 3 an entry), 8 sweeps of the
    3x3's 3 rotations, ~150 for the SVD's vectors and the four candidates,
    and per candidate and point ~60 to set up the secular equation, 3 for
    each of its 33 bisection and Newton steps (the Newton steps' second sum
    counted as 3 more) and ~40 for the depth, cheirality and pixel error."""
    jacobi9 = 6 * 36 * (14 + 3 * (4 * 9 + 2 * 9))
    jacobi3 = 8 * 3 * (14 + 3 * (4 * 3 + 2 * 3))
    return (14 + 9 + 2 * 45) * m + jacobi9 + jacobi3 + 150 + 4 * m * (60 + 3 * 36 + 40)


def ransac_bytes_ops(n: int, hypotheses: int = 256, sample: int = 8, support: int = 16,
                     rounds: int = 2):
    """(bytes, operations) of the RANSAC kernel on one pair of n matches:
    the uniforms (hypotheses x n float32), both sides' (3, n) matches, the
    intrinsics and the valid count read once, the ``RansacResult`` (230
    bytes and 8 a support index) written once; per hypothesis an eight-point
    solve on ``sample`` points and F's Sampson distance on every match (~40
    operations: F x and F^T y, the product, the denominator, the compare
    and the capped sum); per refit round two passes of Sampson distances and
    a solve on ``support`` points."""
    sampson = 40 * n
    ops = (hypotheses * (eight_point_ops(sample) + sampson)
           + rounds * (2 * sampson + eight_point_ops(support)))
    nbytes = 4 * hypotheses * n + 24 * n + 72 + 8 + 230 + 8 * support
    return nbytes, ops


def ransac_bound(n: int, hypotheses: int = 256, sample: int = 8, support: int = 16,
                 rounds: int = 2):
    """``bound`` of the RANSAC kernel (``ransac_bytes_ops``). Neither binds
    in practice: one warp's chain of dependent divisions and square roots
    does (216 Jacobi rotations a solve, three solves in series)."""
    return bound(*ransac_bytes_ops(n, hypotheses, sample, support, rounds))


def ba_bytes_ops(points: int = 60, steps: int = 20, starts: int = 2):
    """(bytes, operations) of the BA kernel on one pair of ``points`` points
    from ``starts`` starts: both sides' (3, points) observations, the
    weights and the intrinsics read once, each start's R, T and (3, points)
    points read once and its ``BAResult`` (149 bytes and its points) written
    once; per point and evaluation ~1,200 float32 operations (the residuals
    and their 4x6 and 4x3 Jacobians ~380, the weights ~55, B, v, E, C and g
    ~400, the 3x3 inverse, E C^-1, the Schur terms ~265, the sums over the
    points ~55, the point's step and its cost ~60) and per step ~400 more
    (the rotation and its tangents, the 6x6 Cholesky and both
    substitutions); ``steps`` evaluations and the start's."""
    ops = starts * ((steps + 1) * 1200 * points + steps * 400)
    nbytes = 28 * points + 72 + starts * (48 + 12 * points + 149 + 12 * points)
    return nbytes, ops


def ba_bound(points: int = 60, steps: int = 20, starts: int = 2):
    """``bound`` of the BA kernel (``ba_bytes_ops``). Neither binds in
    practice: each step's chain does, the per-point terms, three barriers,
    the 6x6 Cholesky and its ~40 dependent divisions and square roots."""
    return bound(*ba_bytes_ops(points, steps, starts))


def sift_bytes_ops(images: int, h: int, w: int, radii, scales: int = 3,
                   octaves: int = 4):
    """(bytes, operations) of the SIFT scale-space kernels' 1 + octaves x
    (scales + 2) level launches and ``octaves`` detection launches on
    ``images`` (h, w) images, ``radii`` the levels' radii in launch order
    (the first level's, then an octave's scales + 2). A level reads its
    source plane and writes its output (the first level of a later octave
    also writes the copied source) and does 2 (4r + 1) operations an output,
    its two passes; a detection reads the octave's scales + 3 planes and
    writes its DoG, response, magnitude and angle planes at the octave's
    size, with ~100 operations a pixel and scale (26 compares each way, the
    Hessian test, the gradient and its square root; atan2 counted as 20).
    The magnitude and angle stacks, octaves x scales planes of (h, w), are
    zeroed first."""
    nbytes = ops = 0
    oh, ow = h, w
    first, per_octave = radii[0], list(radii[1:])
    nbytes += 4 * 2 * h * w + 4 * 2 * octaves * scales * h * w
    ops += 2 * (4 * first + 1) * h * w
    for octave in range(octaves):
        px = oh * ow
        for i, r in enumerate(per_octave):
            nbytes += 4 * px * (3 if octave > 0 and i == 0 else 2)
            ops += 2 * (4 * r + 1) * px
        nbytes += 4 * (scales + 3 + 4 * scales) * px
        ops += 100 * scales * px
        oh, ow = (oh + 1) // 2, (ow + 1) // 2
    return images * nbytes, images * ops


def sift_bound(images: int, h: int, w: int, radii, scales: int = 3, octaves: int = 4):
    """``bound`` of one ``scale_space_kernel`` call (``sift_bytes_ops``)."""
    return bound(*sift_bytes_ops(images, h, w, radii, scales, octaves))


def matcher_roofline(H: int, W: int, D: int, block_size: int = 17,
                     min_disparity: int = 0, WL: int | None = None) -> Dict:
    """The bounds of one pair through the exact matcher on the card, K1
    then K1b (``block_search_right``'s kernel route)."""
    s = dict(h=H, w=W, wl_extra=(W if WL is None else WL) - W, bs=block_size,
             min_d=min_disparity, max_d=min_disparity + D)
    k1_bytes, k1_ops = matcher_bytes_ops(s, out_planes=5)
    scan_bytes, scan_ops = scan_bytes_ops(H, W)
    nbytes, ops = k1_bytes + scan_bytes, k1_ops + scan_ops
    floor = {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": ops / PEAK_FP32 * 1e3}
    binding = max(floor, key=floor.get)
    return {
        "H": H, "W": W, "D": D, "block_size": block_size,
        "bytes": int(nbytes), "operations": int(ops),
        "kernels_ms": {"K1": matcher_bound(s, 5)[0], "K1b": scan_bound(H, W)[0]},
        "floor_ms": floor,
        "binding_resource": binding,
        "floor_ms_binding": floor[binding],
        "peaks": {"bytes_per_s": PEAK_BYTES, "fp32_flops": PEAK_FP32},
    }


def report(measured_ms_per_pair: float, H: int, W: int, D: int,
           block_size: int = 17) -> Dict:
    """The roofline record of a measured matcher time: each bound, the gap
    to the binding one and each bound's share of the measured time."""
    r = matcher_roofline(H, W, D, block_size)
    r["measured_ms_per_pair"] = measured_ms_per_pair
    r["gap_to_binding_bound"] = measured_ms_per_pair / max(r["floor_ms_binding"], 1e-12)
    r["pct_of_peak"] = {k: 100.0 * v / max(measured_ms_per_pair, 1e-12)
                        for k, v in r["floor_ms"].items()}
    return r
