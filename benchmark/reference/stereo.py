"""Plain reference of the calibrated SSD chain: rectification, the
Right-variant block search with its smoothing recurrence, the back-warp
to the original frame, the outlier clamp and depth.

Written from the reference C++ semantics (``rectification.cpp``,
``BlockSearch.cpp:88-179``, ``reconstruction.cpp:5-43``), in plain
PyTorch on any device, and independent of the program's code:

* coordinates of both warps in float64 (the program's are float32);
* window sums of squared differences in float64 (exact for these inputs),
  then the reference's float32 cost ``sqrt(ssd) * (1 / area)``;
* the smoothing recurrence pixel by pixel, as the C++ loop states it,
  walked over anti-diagonals (every pixel of one anti-diagonal depends
  only on the one before), with the first index winning ties.

``low=True`` is the control: the same chain with the warped images and
the cost volume rounded to bfloat16 and the box blur summed in float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from benchmark.reference.loop_zhang import loop_zhang_homographies


def static_canvas(h: int, w: int, scale: float, lane: int = 128) -> Tuple[int, int]:
    """The rectified canvas: ceil(scale * size), rows up to a multiple of 8
    and columns up to a multiple of ``lane``."""
    hc, wc = int(np.ceil(h * scale)), int(np.ceil(w * scale))
    return hc + (-hc) % 8, wc + (-wc) % lane


def _map(H: np.ndarray, out_shape, device):
    """Source coordinates (sx, sy), float64, of every destination pixel
    under the destination-to-source homography H."""
    f64 = dict(dtype=torch.float64, device=device)
    Ht = torch.as_tensor(np.asarray(H, np.float64), **f64)
    ys, xs = torch.meshgrid(torch.arange(out_shape[0], **f64),
                            torch.arange(out_shape[1], **f64), indexing="ij")
    den = Ht[2, 0] * xs + Ht[2, 1] * ys + Ht[2, 2]
    return ((Ht[0, 0] * xs + Ht[0, 1] * ys + Ht[0, 2]) / den,
            (Ht[1, 0] * xs + Ht[1, 1] * ys + Ht[1, 2]) / den)


def warp_bilinear(image: torch.Tensor, H: np.ndarray, out_shape) -> torch.Tensor:
    """dst(p) = src(H^-1 p), bilinear, zero outside the source; (h, w, C)
    float32."""
    h, w = image.shape[:2]
    sx, sy = _map(np.linalg.inv(H), out_shape, image.device)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    img = image.to(torch.float64)

    def tap(yy, xx):
        inside = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h))[..., None]
        v = img[yy.clamp(0, h - 1).long(), xx.clamp(0, w - 1).long()]
        return torch.where(inside, v, 0.0)

    out = (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
           + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)
    return out.to(torch.float32)


def warp_nearest(values: torch.Tensor, H: np.ndarray, out_shape) -> torch.Tensor:
    """dst(p) = src(H p), the nearest source pixel (round half to even),
    zero outside: the back-warp of rectified disparity values with the
    image's own homography H."""
    h, w = values.shape
    sx, sy = _map(H, out_shape, values.device)
    ix, iy = torch.round(sx), torch.round(sy)
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    v = values[iy.clamp(0, h - 1).long(), ix.clamp(0, w - 1).long()]
    return torch.where(inside, v, 0.0)


def ssd_cost_volume(left: torch.Tensor, right: torch.Tensor, block_size: int,
                    min_d: int, max_d: int) -> torch.Tensor:
    """(D, H, W) float32 Right-variant SSD costs, +inf = no candidate.

    Right pixel (y, x) against left pixel (y, x + d): the squared
    differences summed over channels, with the last row and column zeroed,
    summed over the clipped window rows [y - hbs, y + hbs) and columns
    [x - hbs, x + hbs); the area counts min(y, hbs) + min(H-1-y, hbs) rows
    and min(x, hbs) + min(W-1-x, hbs) columns; a candidate needs area > 0
    and x + d + min(W-1-x, hbs) < W_l. Cost sqrt(ssd) * (1 / area) in
    float32."""
    h, w = right.shape[:2]
    w_l = left.shape[1]
    dev = right.device
    hbs = (block_size - 1) // 2
    L = torch.nn.functional.pad(left.to(torch.float64), (0, 0, 0, w + max_d))
    R = right.to(torch.float64)
    ys, xs = torch.arange(h, device=dev), torch.arange(w, device=dev)
    y0, y1 = (ys - hbs).clamp(min=0), (ys + hbs).clamp(max=h)
    x0, x1 = (xs - hbs).clamp(min=0), (xs + hbs).clamp(max=w)
    rgt = (w - 1 - xs).clamp(max=hbs)
    area = (xs.clamp(max=hbs) + rgt)[None, :] * (ys.clamp(max=hbs)
                                                 + (h - 1 - ys).clamp(max=hbs))[:, None]
    inv_area = 1.0 / area.to(torch.float32)
    cost = torch.empty((max_d - min_d, h, w), dtype=torch.float32, device=dev)
    for i, d in enumerate(range(min_d, max_d)):
        dsq = ((L[:, d:d + w] - R) ** 2).sum(-1)
        dsq[h - 1, :] = 0
        dsq[:, w - 1] = 0
        c = torch.nn.functional.pad(dsq.cumsum(0).cumsum(1), (1, 0, 1, 0))
        ssd = (c[y1][:, x1] - c[y0][:, x1] - c[y1][:, x0] + c[y0][:, x0])
        plane = torch.sqrt(ssd.to(torch.float32).to(torch.float64)).to(torch.float32) * inv_area
        ok = (area > 0) & ((xs + d + rgt) < w_l)[None, :]
        cost[i] = torch.where(ok, plane, math.inf)
    return cost


def smoothed_disparity(cost: torch.Tensor, black: torch.Tensor, min_d: int,
                       smooth_factor: float) -> torch.Tensor:
    """The reference's interleaved smoothing (BlockSearch.cpp:160-171),
    pixel by pixel: a candidate's cost is multiplied by ``smooth_factor``
    once for each of the up and left neighbours whose disparity is minus
    its value; the first minimum wins; no finite candidate gives -x, a
    black right pixel 0. (H, W) float32."""
    D, h, w = cost.shape
    dev = cost.device
    sf = torch.tensor(smooth_factor, dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    out = torch.zeros((h, w), dtype=torch.float32, device=dev)
    for k in range(h + w - 1):
        y = torch.arange(max(0, k - w + 1), min(h - 1, k) + 1, device=dev)
        x = k - y
        c = cost[:, y, x].clone()                                     # (D, n)
        for ny, nx, has in ((y - 1, x, y >= 1), (y, x - 1, x >= 1)):
            neighbour = out[ny.clamp(min=0), nx.clamp(min=0)]
            idx = (-neighbour).to(torch.int64) - min_d
            hit = has & (idx >= 0) & (idx < D)
            idx = idx.clamp(0, D - 1)[None]
            c.scatter_(0, idx, c.gather(0, idx) * torch.where(hit, sf, one)[None])
        best = torch.argmin(c, dim=0)
        finite = torch.isfinite(c.gather(0, best[None])[0])
        disp = torch.where(finite, (best + min_d).to(torch.float32), -x.to(torch.float32))
        out[y, x] = torch.where(black[y, x], 0.0, disp)
    return out


def box_blur(img: torch.Tensor, k: int, dtype=torch.float64) -> torch.Tensor:
    """cv::blur: the mean over a k x k window, BORDER_REFLECT_101, summed
    in ``dtype``; float32 out."""
    h, w = img.shape
    a = (k - 1) // 2

    def reflect(n):
        idx = torch.arange(-a, n + k - 1 - a, device=img.device)
        period = max(2 * n - 2, 1)
        idx = torch.remainder(idx, period)
        return torch.where(idx >= n, period - idx, idx)

    x = img.to(dtype)[reflect(h)][:, reflect(w)]
    for dim in (0, 1):
        c = torch.cat([torch.zeros_like(x.narrow(dim, 0, 1)), x.cumsum(dim)], dim)
        n = c.shape[dim] - k
        x = c.narrow(dim, k, n) - c.narrow(dim, 0, n)
    return (x / (k * k)).to(torch.float32)


def ssd_pair(left: np.ndarray, right: np.ndarray, K_right: np.ndarray, F: np.ndarray,
             pipeline: dict, device, low: bool = False):
    """(disparity, depth), float32 NumPy (H, W), of the pair (uint8 (H, W,
    3) images) rectified by F: the chain of ``run_pair(fixed_F=F)`` under
    the settings of ``pipeline`` (the configuration file's section)."""
    m, rc = pipeline["matcher"], pipeline["recon"]
    h, w = right.shape[:2]
    H_left, H_right = loop_zhang_homographies(F, (h, w), (h, w))
    canvas = static_canvas(h, w, pipeline["rectify"]["canvas_scale"])
    lr = warp_bilinear(torch.as_tensor(left, device=device), H_left, canvas)
    rr = warp_bilinear(torch.as_tensor(right, device=device), H_right, canvas)
    black = (rr == 0).all(-1)
    if low:
        lr, rr = (t.to(torch.bfloat16).to(torch.float32) for t in (lr, rr))
    cost = ssd_cost_volume(lr, rr, m["block_size"], m["min_disparity"], m["max_disparity"])
    if low:
        cost = cost.to(torch.bfloat16).to(torch.float32)
    disp_rect = smoothed_disparity(cost, black, m["min_disparity"], m["smooth_factor"])
    del cost
    disp = warp_nearest(disp_rect, H_right, (h, w))
    blurred = box_blur(disp, rc["outlier_kernel"], torch.float32 if low else torch.float64)
    outlier = (disp > rc["outlier_front"] * blurred) | (disp < rc["outlier_back"] * blurred)
    clean = torch.where(outlier, blurred, disp)
    fb = (torch.tensor(float(K_right[0, 0]), dtype=torch.float32)
          * torch.tensor(rc["baseline"], dtype=torch.float32)).to(device)
    depth = torch.where(clean == 0, -math.inf, fb / torch.where(clean == 0, 1.0, clean))
    return disp.cpu().numpy(), depth.cpu().numpy()
