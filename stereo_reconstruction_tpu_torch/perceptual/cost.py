"""Perceptual (LPIPS) cost volumes and window searches.

Port of ``stereo_reconstruction_tpu/perceptual/cost.py`` (BASELINE
config 3, the reference notebook ``Perceptual_window_search.ipynb`` cells
6-10), with ``config.mode`` selecting the backend:

* ``"windowed"`` (default): every pixel's zero-padded ``window x window``
  crop goes through the VGG tower on its own, as in the notebook; the LPIPS
  distance of each candidate is expanded into norm and cross terms, so a
  row block's candidates are a band of one batched Gram product
  (``windowed_lpips_cost_volume``). The host loops over row blocks in
  place of JAX's ``lax.scan``; the convolutions go to cuDNN and the Gram to
  ``torch.bmm`` in float32 (TF32 is off, ``__init__``), as JAX left both to
  XLA. The notebook's chunked smoothing then runs in K4
  (``perceptual/scan.py``) on the card and in its plain twin on the CPU.
* ``"full_image"``: full-image features and shifted normalised-feature
  differences per stage, box-averaged over the window footprint
  (``lpips_cost_volume``), then the row-global smoothing with fixed Jacobi
  sweeps (``perceptual_smooth_argmin``, plain PyTorch).

The notebook's weight ``(1 - exp(-|i - argmin_prev| / sigma)) + bias``
(cell 8, bias 0.85, sigma 25) only ever sees integer distances, so both
smoothers read it from a table (``scan.weight_table``), which a caller may
pass in (``table=``).

Each windowed row takes its own crops: JAX's ``dynamic_slice`` clamps the
last row block's start when ``row_block`` does not divide H, which moves
that block's rows up by the excess; the port pads rows instead, and equals
JAX wherever JAX does not clamp (``row_block`` 1, or dividing H).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from stereo_reconstruction_tpu_torch.config import PerceptualConfig
from stereo_reconstruction_tpu_torch.perceptual.scan import weight_table, window_scan
from stereo_reconstruction_tpu_torch.perceptual.vgg import (
    STAGE_STRIDES,
    Params,
    as_module,
    normalize_features,
    scale_input,
    stage_lins,
    vgg16_features,
)
from stereo_reconstruction_tpu_torch.utils.profiling import span


def _box_mean(cost: torch.Tensor, win: int) -> torch.Tensor:
    """(hs, ws) mean over a win x win window with zero padding
    ``(win // 2, win - 1 - win // 2)`` on each axis (JAX ``reduce_window``
    add, then / win^2)."""
    lo, hi = win // 2, win - 1 - win // 2
    padded = F.pad(cost[None, None], (lo, hi, lo, hi))
    return F.avg_pool2d(padded, win, stride=1)[0, 0]


@torch.inference_mode()
def lpips_cost_volume(
    params: Params,
    left: torch.Tensor,      # (H, W, 3) RGB [0, 255]
    right: torch.Tensor,     # (H, W, 3)
    config: PerceptualConfig = PerceptualConfig(),
) -> torch.Tensor:
    """(D, H, W) full-image perceptual cost volume for right-image
    disparities, D = ``config.max_disparity``; +inf where x + d >= W."""
    h, w = right.shape[:2]
    dev = right.device
    D = config.max_disparity
    module = as_module(params, dev)
    feats_l = [normalize_features(f) for f in vgg16_features(module, left)]
    feats_r = [normalize_features(f) for f in vgg16_features(module, right)]
    lins = stage_lins(module, [f.shape[0] for f in feats_l])

    total = torch.zeros((D, h, w), dtype=torch.float32, device=dev)
    for s, (fl, fr, lin) in enumerate(zip(feats_l, feats_r, lins)):
        stride = STAGE_STRIDES[s]
        ws = fl.shape[2]
        # per integer shift, the lin-weighted squared difference at stage
        # resolution, box-averaged over the window footprint
        max_shift = (D - 1) // stride + 2
        fl_pad = F.pad(fl, (0, max_shift))
        win_s = max(1, config.window_size // stride)
        shifts = []
        for k in range(max_shift):
            cost = torch.einsum("c,chw->hw", lin, (fl_pad[:, :, k:k + ws] - fr) ** 2)
            shifts.append(_box_mean(cost, win_s) if win_s > 1 else cost)
        stage_cost = torch.stack(shifts)                         # (S, hs, ws)

        # pixel disparities -> fractional stage shifts, linear between the
        # two neighbouring integer shifts
        dvals = torch.arange(D, dtype=torch.float32, device=dev) / stride
        k0 = torch.floor(dvals).to(torch.long)
        frac = (dvals - k0)[:, None, None]
        c0 = stage_cost[k0.clamp(0, max_shift - 1)]
        c1 = stage_cost[(k0 + 1).clamp(0, max_shift - 1)]
        vol_s = c0 * (1 - frac) + c1 * frac

        # nearest upsample to (H, W); the pools floor the stage size, so the
        # last row and column are replicated up to the full image
        if stride > 1:
            vol_s = vol_s.repeat_interleave(stride, 1).repeat_interleave(stride, 2)
        vol_s = vol_s[:, :h, :w]
        pad_h, pad_w = h - vol_s.shape[1], w - vol_s.shape[2]
        if pad_h > 0 or pad_w > 0:
            vol_s = F.pad(vol_s[None], (0, pad_w, 0, pad_h), mode="replicate")[0]
        total = total + vol_s

    xs = torch.arange(w, device=dev)
    valid = (xs[None, None, :] + torch.arange(D, device=dev)[:, None, None]) < w
    return torch.where(valid, total, torch.inf)


@torch.inference_mode()
def perceptual_smooth_argmin(
    cost: torch.Tensor,           # (D, H, W)
    config: PerceptualConfig = PerceptualConfig(),
    iters: int = 2,
    table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The notebook's multiplicative smoothing for the full-image volume:
    each row weighted around the previous row's argmins, then ``iters - 1``
    Jacobi sweeps of the previous-pixel weight (fixed sweeps, not a
    fixpoint), a pixel with no finite candidate 0. (H, W) float32."""
    D, h, w = cost.shape
    dev = cost.device
    if table is None:
        table = weight_table(D, config.smoothing_sigma, config.smoothing_bias, dev)
    dvals = torch.arange(D, dtype=torch.float32, device=dev)[:, None]

    def weights(prev_idx):
        """(W,) previous argmins -> (D, W) weights; NaN = no weighting."""
        nan = torch.isnan(prev_idx)
        k = (dvals - torch.where(nan, 0.0, prev_idx)).abs().to(torch.long)
        return torch.where(nan, 1.0, table[k])

    def resolve(c):
        idx = torch.argmin(c, dim=0).to(torch.float32)
        return torch.where(torch.isfinite(torch.amin(c, dim=0)), idx, 0.0)

    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    nan = torch.full((1,), torch.nan, device=dev)
    for y in range(h):
        cu = cost[:, y] if y == 0 else cost[:, y] * weights(out[y - 1])
        disp = resolve(cu)
        for _ in range(max(0, iters - 1)):
            disp = resolve(cu * weights(torch.cat([nan, disp[:-1]])))
        out[y] = disp
    return out


def perceptual_window_search(
    params: Params,
    left: torch.Tensor,
    right: torch.Tensor,
    config: PerceptualConfig = PerceptualConfig(),
) -> torch.Tensor:
    """The perceptual disparity search (BASELINE config 3), on the device
    of the images: ``config.mode`` ``"windowed"`` (default, the notebook's
    per-window semantics) or ``"full_image"`` (shared full-image
    features)."""
    if config.mode == "full_image":
        return perceptual_smooth_argmin(lpips_cost_volume(params, left, right, config), config)
    return windowed_lpips_search(params, left, right, config)


def _windows(padded: torch.Tensor, y0: int, rows: int, win: int, w: int) -> torch.Tensor:
    """(rows * W, 3, win, win) crops of a (3, Hp, Wp) padded image: crop
    (r, x) is ``padded[:, y0 + r : y0 + r + win, x : x + win]``."""
    strip = padded[:, y0:y0 + rows + win - 1]
    crops = strip.unfold(1, win, 1).unfold(2, win, 1)[:, :, :w]   # (3, rows, W, win, win)
    return crops.permute(1, 2, 0, 3, 4).reshape(rows * w, 3, win, win)


@torch.inference_mode()
def windowed_lpips_cost_volume(
    params: Params,
    left: torch.Tensor,      # (H, W, 3) RGB [0, 255]
    right: torch.Tensor,     # (H, W, 3)
    config: PerceptualConfig = PerceptualConfig(),
) -> torch.Tensor:
    """(H, D, W) per-window LPIPS cost volume, D = min(max_disparity, W),
    +inf where x + d >= W.

    Every pixel owns the ``window x window`` crop of the zero-padded image
    with top-left (y - padding, x - padding), forwarded through the tower on
    its own (the notebook's cell 6 unfold). Per stage, with n the
    channel-normalised features, l the lins and sp the stage's spatial size,
    the distance of right crop x to left crop x + d is
    ``(sum l n_r^2 + sum l n_l^2 - 2 sum l n_r n_l) / sp``; the cross terms of
    a block of ``config.row_block`` rows are the first D diagonals of one
    batched (W, W) Gram product."""
    h, w = right.shape[:2]
    dev = right.device
    D = min(config.max_disparity, w)
    win, pad = config.window_size, config.padding
    if win > 2 * pad + 1:
        raise ValueError(f"window {win} needs padding >= {(win - 1) // 2}, got {pad}")
    R = max(1, min(config.row_block, h))
    n_blocks = -(-h // R)
    module = as_module(params, dev)
    lins = stage_lins(module)

    def prepare(image):
        # zero pad in pixel space (extra rows below fill the last block),
        # then the LPIPS scaling, which is elementwise: the crops of the
        # scaled image are the scaled crops
        padded = F.pad(image.to(torch.float32), (0, 0, pad, pad, pad, pad + n_blocks * R - h))
        return scale_input(padded).permute(2, 0, 1)

    padded_l, padded_r = prepare(left), prepare(right)
    xs = torch.arange(w, device=dev)
    d = torch.arange(D, device=dev)
    band = (xs[:, None] + d[None, :]).clamp(max=w - 1)            # (W, D) left column
    valid = (xs[None, :] + d[:, None]) < w                        # (D, W)
    volume = torch.empty((h, D, w), dtype=torch.float32, device=dev)
    for b in range(n_blocks):
        y0 = b * R
        with span("perceptual.tower", dev):
            ls = module(_windows(padded_l, y0, R, win, w))
            rs = module(_windows(padded_r, y0, R, win, w))
        with span("perceptual.distance", dev):
            total = torch.zeros((R, D, w), dtype=torch.float32, device=dev)
            for fl, fr, lin in zip(ls, rs, lins):
                nl = normalize_features(fl, dim=1)
                nr = normalize_features(fr, dim=1)
                sp = nl.shape[2] * nl.shape[3]
                lin = lin[None, :, None, None]
                wl = nl * lin                                     # lin folded into left
                t_l = torch.sum(wl * nl, dim=(1, 2, 3)).reshape(R, w) / sp
                t_r = torch.sum(nr * nr * lin, dim=(1, 2, 3)).reshape(R, w) / sp
                gram = torch.bmm(nr.reshape(R, w, -1),
                                 wl.reshape(R, w, -1).transpose(1, 2)) / sp
                cross = torch.gather(gram, 2, band.expand(R, w, D))   # (R, W, D)
                total = total + (t_r[:, None, :] + t_l[:, band].transpose(1, 2)
                                 - 2.0 * cross.transpose(1, 2))
            rows = min(R, h - y0)
            volume[y0:y0 + rows] = torch.where(valid, total[:rows], torch.inf)
    return volume


def windowed_smooth_argmin(
    cost: torch.Tensor,           # (H, D, W) from windowed_lpips_cost_volume
    config: PerceptualConfig = PerceptualConfig(),
    table: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The notebook's chunked multiplicative smoothing (cell 10) with its
    quirks: the previous-pixel term resets every ``config.chunk`` pixels,
    its argmin is clamped to ``min(prev, size)`` with size the current
    pixel's candidate count, and the previous-row term is row-global.
    (H, W) float32 argmin indices, by K4 on the card and its plain twin on
    the CPU; ``table`` defaults to ``scan.weight_table``."""
    D = cost.shape[1]
    if table is None:
        table = weight_table(D, config.smoothing_sigma, config.smoothing_bias, cost.device)
    return window_scan(cost.contiguous(), table, config.chunk)


def windowed_lpips_search(
    params: Params,
    left: torch.Tensor,      # (H, W, 3) RGB [0, 255]
    right: torch.Tensor,     # (H, W, 3)
    config: PerceptualConfig = PerceptualConfig(),
) -> torch.Tensor:
    """The notebook's per-window LPIPS search: the row-blocked cost volume,
    then the chunked smoothing."""
    return windowed_smooth_argmin(windowed_lpips_cost_volume(params, left, right, config),
                                  config)
