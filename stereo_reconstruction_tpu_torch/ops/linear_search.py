"""Linear (1x1-window) dense search, the reference's LinearSearch.

Port of ``stereo_reconstruction_tpu/ops/linear_search.py``
(``src/WindowSearch/LinearSearch.cpp:10-59``): per-pixel RGB L2 distance
over a fixed search band to the right, with the same multiplicative
smoothness discount, sign quirk included (the discount compares the
neighbour's disparity with ``j - k = -d``, LinearSearch.cpp:39-44, while
+d is stored). With the default ``iters=None`` the recurrence is solved
exactly by the Right variant's row scan on the volume's five planes
(``smoothing.volume_reductions``, then ``cuda_row_scan.row_scan``: K1b on
CUDA tensors, its plain twin on CPU ones), which equals JAX's fixpoint
smoother; a fixed ``iters`` runs that many sweeps of
``smoothing.smoothed_argmin``.

Quirks kept from the reference:
  * the *left* image is tested for black pixels while the right image is
    matched (LinearSearch.cpp:24);
  * candidates past the left image's width are skipped (the reference reads
    out of bounds there).
"""

from __future__ import annotations

from typing import Optional

import torch

from stereo_reconstruction_tpu_torch.ops import cuda_row_scan as crs
from stereo_reconstruction_tpu_torch.ops import smoothing
from stereo_reconstruction_tpu_torch.ops.cost_volume import D_CHUNK, sqrt_rn


def _with_channels(img: torch.Tensor) -> torch.Tensor:
    """float32 (H, W, C); a grayscale (H, W) image gets one channel."""
    img = img.to(torch.float32)
    return img[..., None] if img.ndim == 2 else img


def cost_volume_linear(
    left: torch.Tensor,     # (H, WL, 3)
    right: torch.Tensor,    # (H, W, 3)
    search_range: int = 200,
) -> torch.Tensor:
    """(D, H, W) per-pixel distance volume, plane d = disparity d;
    +inf = invalid candidate."""
    left = _with_channels(left)
    right = _with_channels(right)
    h, w = right.shape[:2]
    wl = left.shape[1]
    device = right.device
    left_p = torch.nn.functional.pad(left, (0, 0, 0, max(0, w + search_range - wl)))
    xs = torch.arange(w, device=device)
    out = torch.empty((search_range, h, w), dtype=torch.float32, device=device)
    for c0 in range(0, search_range, D_CHUNK):
        ds = range(c0, min(c0 + D_CHUNK, search_range))
        sq = (torch.stack([left_p[:, d:d + w] for d in ds]) - right) ** 2
        dsq = sq[..., 0]
        for c in range(1, sq.shape[-1]):
            dsq = dsq + sq[..., c]
        valid = (xs[None, :] + torch.tensor(list(ds), device=device)[:, None]) < wl
        out[c0:c0 + len(ds)] = torch.where(valid[:, None, :], sqrt_rn(dsq), float("inf"))
    return out


def linear_search(
    left: torch.Tensor,
    right: torch.Tensor,
    smooth_factor: float = 0.9,
    search_range: int = 200,
    iters: Optional[int] = None,   # None = the exact recurrence (the row scan)
) -> torch.Tensor:
    """(H, W) float32 disparity of the right image (LinearSearch semantics)."""
    left = _with_channels(left)
    right = _with_channels(right)
    cost = cost_volume_linear(left, right, search_range)
    # reference quirk: the black-pixel test reads the LEFT image
    black = (left[:, :right.shape[1]] == 0).all(dim=-1).contiguous()
    if iters is None:
        planes = smoothing.volume_reductions(cost, 0)
        del cost
        disp = crs.row_scan(*planes, black, smooth_factor=smooth_factor, d_first=0,
                            n_planes=search_range)
    else:
        dvals = torch.arange(search_range, device=right.device)
        disp = smoothing.smoothed_argmin(cost, dvals, black, smooth_factor=smooth_factor,
                                         mode="reference", iters=iters, variant="right")
    h = min(left.shape[0], right.shape[0])
    rows_valid = torch.arange(disp.shape[0], device=disp.device) < h
    return torch.where(rows_valid[:, None], disp, 0.0)
