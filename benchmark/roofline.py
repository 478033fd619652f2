"""The least time an NVIDIA H100 SXM can take for a function's work, and
the float32 operations of a request, counted from shapes.

``bound``, ``matcher_bytes_ops`` and ``scan_bytes_ops`` copy the port's
``utils/roofline.py`` (peaks from NVIDIA's data sheet: 3.35 TB/s of HBM3,
67 TFLOP/s of float32 outside the tensor cores). A bound is the
function's: each input read once, each output written once, the
operations these inputs need; scratch a kernel keeps for itself is not in
it. ``vgg_search_flops`` counts the perceptual search's convolutions and
its Gram band.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from benchmark.reference.lpips import VGG16_BLOCKS
from benchmark.reference.stereo import static_canvas

PEAK_BYTES = 3.35e12     # HBM3 bytes/s
PEAK_FP32 = 67e12        # float32 FLOP/s


def bound(nbytes: float, ops: float):
    """(ms, what binds): the larger of the bytes over the memory rate and
    the float32 operations over the peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matcher_bytes_ops(s: Dict, out_planes: int):
    """(bytes, operations) of a window-cost kernel (K1) at shape ``s`` =
    dict(h, w, wl_extra, bs, min_d, max_d) with ``out_planes`` (H, W)
    float32 outputs: both images read once, the outputs written once, and
    per (pixel, plane) with a candidate 9 operations of squared
    difference, 2 x 2hbs window adds, a sqrt, a multiply and a compare."""
    h, w, hbs = s["h"], s["w"], (s["bs"] - 1) // 2
    wl, min_d, d = w + s["wl_extra"], s["min_d"], s["max_d"] - s["min_d"]
    pairs = 0
    if hbs > 0 and h > 1 and w > 1:
        reach = np.minimum(w - 1, np.arange(w) + hbs)    # x + min(W-1-x, hbs)
        pairs = h * int(np.clip(wl - reach - min_d, 0, d).sum())
    return 4 * 3 * h * (w + wl) + 4 * out_planes * h * w, pairs * (9 + 4 * hbs + 3)


def scan_bytes_ops(h: int, w: int):
    """(bytes, operations) of K1b on an (h, w) image: five planes and the
    mask read, the disparity written (25 bytes a pixel), ~30 float32
    operations a pixel."""
    return 25 * h * w, 30 * h * w


def ssd_shape(config: dict) -> Dict:
    """The matcher's shape on the canvas of an SSD configuration file."""
    p, img = config["pipeline"], config["image"]
    hc, wc = static_canvas(img["height"], img["width"], p["rectify"]["canvas_scale"])
    m = p["matcher"]
    return dict(h=hc, w=wc, wl_extra=0, bs=m["block_size"], min_d=m["min_disparity"],
                max_d=m["max_disparity"])


def k1_bound_ms(config: dict) -> float:
    return bound(*matcher_bytes_ops(ssd_shape(config), out_planes=5))[0]


def k1b_bound_ms(config: dict) -> float:
    s = ssd_shape(config)
    return bound(*scan_bytes_ops(s["h"], s["w"]))[0]


def ssd_pair_flops(config: dict) -> float:
    """float32 operations of the matcher's function on one pair (K1, then
    K1b); the warps and the reconstruction add little and are left out."""
    s = ssd_shape(config)
    return matcher_bytes_ops(s, out_planes=5)[1] + scan_bytes_ops(s["h"], s["w"])[1]


def _conv_taps(n: int) -> int:
    """Products a 3x3 SAME convolution needs per input and output channel
    on an n x n map: the taps that land inside it, (3n - 2)^2."""
    return (3 * n - 2) ** 2


def vgg_crop_flops(window: int) -> Tuple[float, list]:
    """(float32 operations of one window x window crop through the VGG-16
    tower, [(channels, side)] of its five stages): 2 per product over the
    taps inside the map; the 2x2 pools floor the side."""
    flops, side, c_in, stages = 0.0, window, 3, []
    for bi, (c_out, n) in enumerate(VGG16_BLOCKS):
        for _ in range(n):
            flops += 2.0 * _conv_taps(side) * c_in * c_out
            c_in = c_out
        stages.append((c_out, side))
        if bi < len(VGG16_BLOCKS) - 1:
            side //= 2
    return flops, stages


def vgg_search_flops(h: int, w: int, max_disparity: int, window: int) -> float:
    """float32 operations of one perceptual search at (h, w): every right
    and left pixel's crop through the tower, and per pixel and candidate
    with x + d < W the Gram band's product over every stage's features."""
    crop, stages = vgg_crop_flops(window)
    features = sum(c * side * side for c, side in stages)
    D = min(max_disparity, w)
    candidates = h * int(np.minimum(D, w - np.arange(w)).sum())
    return 2 * h * w * crop + 2.0 * candidates * features


def perceptual_search_flops(config: dict) -> float:
    p, img = config["pipeline"], config["image"]
    return vgg_search_flops(img["height"], img["width"], p["matcher"]["max_disparity"],
                            p["perceptual"]["window_size"])
