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
