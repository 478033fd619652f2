"""The literal per-window oracle of the perceptual search.

Port of ``stereo_reconstruction_tpu/perceptual/notebook_oracle.py``: the
reference notebook ``Perceptual_window_search.ipynb`` cells 6-10 row by
row. Every pixel's zero-padded ``window x window`` crop goes through the
port's VGG tower on its own; the LPIPS distances of a row form a (W, W)
matrix on the device; the candidate scores, the multiplicative smoothing
(previous row, and previous pixel inside a ``chunk``-pixel chunk with the
``min(argmins[-1], size)`` clamp) and the argmins run in float64 on the
host, as the notebook does. It is a check of the windowed search's
semantics and is never on the main path. Inputs are RGB [0, 255] in the
framework's [-1, 1] -> scaling-layer convention (``vgg.scale_input``), as
in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from stereo_reconstruction_tpu_torch.perceptual.vgg import (
    Params,
    as_module,
    normalize_features,
    stage_lins,
    vgg16_features_batched,
)


@torch.inference_mode()
def _row_window_features(module, image: torch.Tensor, y: int, window: int = 17,
                         padding: int = 8):
    """Per-window VGG stages (W, C_s, h_s, w_s) of every pixel of row y;
    window x has its top-left at (y - padding, x - padding)."""
    w = image.shape[1]
    padded = F.pad(image, (0, 0, padding, padding, padding, padding))
    strip = padded[y:y + window]                               # (win, Wp, 3)
    crops = strip.unfold(1, window, 1)[:, :w]                  # (win_i, W, 3, win_j)
    return vgg16_features_batched(module, crops.permute(1, 0, 3, 2))


@torch.inference_mode()
def _row_distance_matrix(left_stages, right_stages, lins) -> np.ndarray:
    """(W, W) LPIPS distances D[x, xl] = lpips(right window x, left window
    xl) (cell 8 ``compute_distance``): per stage unit-normalise channels,
    squared difference, lins weighting, spatial mean; summed over stages."""
    w = right_stages[0].shape[0]
    total = torch.zeros((w, w), dtype=torch.float32, device=right_stages[0].device)
    for fl, fr, lin in zip(left_stages, right_stages, lins):
        nl = normalize_features(fl, dim=1)
        nr = normalize_features(fr, dim=1)
        lin4 = lin[None, :, None, None]
        sp = nl.shape[2] * nl.shape[3]
        cross = nr.reshape(w, -1) @ (nl * lin4).reshape(w, -1).T / sp
        total = total + ((nr * nr * lin4).sum(1).mean((1, 2))[:, None]
                         + (nl * nl * lin4).sum(1).mean((1, 2))[None, :] - 2.0 * cross)
    return total.cpu().numpy()


def _weight_vector(size: int, mean_idx: float, sigma: float, bias: float) -> np.ndarray:
    """Cell 8 ``weight_vector``."""
    idx = np.arange(size, dtype=np.float64)
    return (1.0 - np.exp(-np.abs(idx - float(mean_idx)) / sigma)) + bias


def _oracle_row(dist: np.ndarray, y: int, prev_row, max_disparity: int, chunk: int,
                smoothing_bias: float, smoothing_sigma: float) -> np.ndarray:
    """Cell 10 on one row's distance matrix, ``prev_row`` the row above."""
    w = dist.shape[0]
    row = np.zeros((w,), np.float32)
    for x0 in range(0, w, chunk):
        argmins: list = []
        for x in range(x0, min(x0 + chunk, w)):
            cut = min(x + max_disparity, w)
            size = cut - x
            scores = dist[x, x:cut].astype(np.float64).copy()
            if y > 0:
                scores *= _weight_vector(size, prev_row[x], smoothing_sigma, smoothing_bias)
            if argmins:
                scores *= _weight_vector(size, min(argmins[-1], size), smoothing_sigma,
                                         smoothing_bias)
            argmins.append(int(np.argmin(scores)))
            row[x] = argmins[-1]
    return row


def _prepare(params: Params, left, right, device):
    device = torch.device(device)
    module = as_module(params, device)
    left = torch.as_tensor(np.asarray(left), dtype=torch.float32).to(device)
    right = torch.as_tensor(np.asarray(right), dtype=torch.float32).to(device)
    return module, left, right, stage_lins(module)


def notebook_window_search(
    params: Params,
    left,                        # (H, W, 3) RGB float/uint8 [0, 255]
    right,
    window: int = 17,
    padding: int = 8,
    max_disparity: int = 200,
    chunk: int = 20,
    smoothing_bias: float = 0.85,
    smoothing_sigma: float = 25.0,
    n_rows: int | None = None,
    device="cuda",
) -> np.ndarray:
    """The notebook's full window search (cell 10), row by row: (H, W)
    float32 argmin indices. ``n_rows`` limits the scan to the first rows
    (exact for those rows: the recurrence only looks upward). The crops
    and distances run on ``device``."""
    module, left, right, lins = _prepare(params, left, right, device)
    h, w = right.shape[:2]
    disparity = np.zeros((h, w), np.float32)
    for y in range(h if n_rows is None else min(n_rows, h)):
        dist = _row_distance_matrix(_row_window_features(module, left, y, window, padding),
                                    _row_window_features(module, right, y, window, padding),
                                    lins)
        disparity[y] = _oracle_row(dist, y, disparity[y - 1] if y > 0 else None,
                                   max_disparity, chunk, smoothing_bias, smoothing_sigma)
    return disparity


def notebook_rows(
    params: Params,
    left,
    right,
    rows,                        # iterable of row indices y
    prev_disparity: np.ndarray,  # (H, W) source of each row's row y-1
    window: int = 17,
    padding: int = 8,
    max_disparity: int = 200,
    chunk: int = 20,
    smoothing_bias: float = 0.85,
    smoothing_sigma: float = 25.0,
    device="cuda",
) -> Dict[int, np.ndarray]:
    """Oracle rows at arbitrary y, each conditioned on the caller's row
    y-1 (``prev_disparity``): fed a search's own row y-1, the oracle row
    equals that search's row y exactly when the search has the notebook's
    semantics."""
    module, left, right, lins = _prepare(params, left, right, device)
    prev_disparity = np.asarray(prev_disparity)
    out: Dict[int, np.ndarray] = {}
    for y in rows:
        y = int(y)
        dist = _row_distance_matrix(_row_window_features(module, left, y, window, padding),
                                    _row_window_features(module, right, y, window, padding),
                                    lins)
        out[y] = _oracle_row(dist, y, prev_disparity[y - 1] if y > 0 else None,
                             max_disparity, chunk, smoothing_bias, smoothing_sigma)
    return out
