"""Plain reference of the perceptual (LPIPS VGG-16) window search of the
reference notebook (``Perceptual_window_search.ipynb`` cells 6-10; LPIPS,
Zhang et al., arXiv:1801.03924), in plain PyTorch on any device.

* The weights: seeded He-init VGG-16 (widths 64/128/256/512/512) and
  unit stage weights 1/C, drawn from ``numpy.random.default_rng(seed)``
  in the layout the project has always used for them.
* Every right and left pixel owns the ``window x window`` crop of its
  zero-padded image; the crop is scaled as LPIPS scales its input and runs
  through the tower (3x3 SAME convolutions and ReLU, 2x2 max pools between
  blocks) in float32, TF32 off.
* Per stage the features are unit-normalised over channels and the
  distance of right crop x to left crop x + d is
  ``sum_c l_c |n_r - n_l|^2`` averaged over the stage's positions; this
  is summed as norms and cross terms in float64 (no cancellation at
  float32's scale). +inf where x + d >= W.
* The chunked smoothing of cell 10, row after row and, inside a row,
  position p of every chunk at once.

``low=True`` is the control: every operand of the convolutions and of
the cross terms rounded to TF32 (10 mantissa bits, as the tensor cores
take them) and the cross terms summed in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

VGG16_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


def vgg16_weights(seed: int):
    """[[(w, b), ...] per block] float32 NumPy: He-normal convs, zero
    biases, drawn block by block in order from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    blocks, in_ch = [], 3
    for out_ch, n in VGG16_BLOCKS:
        block = []
        for _ in range(n):
            wt = rng.normal(0, np.sqrt(2.0 / (9 * in_ch)), (out_ch, in_ch, 3, 3))
            block.append((wt.astype(np.float32), np.zeros(out_ch, np.float32)))
            in_ch = out_ch
        blocks.append(block)
    return blocks


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def tower(x: torch.Tensor, blocks, low: bool = False):
    """Stage outputs (N, C_s, h_s, w_s) of scaled (N, 3, h, w) input."""
    stages = []
    for bi, block in enumerate(blocks):
        for wt, b in block:
            if low:
                x, wt = round_tf32(x), round_tf32(wt)
            x = F.relu(F.conv2d(x, wt, b, padding=1))
        stages.append(x)
        if bi < len(blocks) - 1:
            x = F.max_pool2d(x, 2)
    return stages


def _scaled_padded(image: torch.Tensor, pad: int, extra_rows: int) -> torch.Tensor:
    """(3, H + 2 pad + extra, W + 2 pad): the image zero-padded in pixel
    space, then mapped to [-1, 1] and through LPIPS's scaling layer."""
    x = F.pad(image.to(torch.float32), (0, 0, pad, pad, pad, pad + extra_rows))
    shift = torch.tensor(LPIPS_SHIFT, device=x.device)
    scale = torch.tensor(LPIPS_SCALE, device=x.device)
    return ((x / 127.5 - 1.0 - shift) / scale).permute(2, 0, 1)


def cost_volume(left: torch.Tensor, right: torch.Tensor, seed: int, pcfg: dict,
                max_disparity: int, low: bool = False) -> torch.Tensor:
    """(H, D, W) float32 per-window LPIPS costs, D = min(max_disparity, W),
    computed ``pcfg["row_block"]`` rows at a time."""
    h, w = right.shape[:2]
    dev = right.device
    D = min(max_disparity, w)
    win, pad = pcfg["window_size"], pcfg["padding"]
    R = max(1, min(pcfg["row_block"], h))
    n_blocks = -(-h // R)
    blocks = [[(torch.as_tensor(wt, device=dev), torch.as_tensor(b, device=dev))
               for wt, b in block] for block in vgg16_weights(seed)]
    pl = _scaled_padded(left, pad, n_blocks * R - h)
    pr = _scaled_padded(right, pad, n_blocks * R - h)
    xs = torch.arange(w, device=dev)
    d = torch.arange(D, device=dev)
    band = (xs[:, None] + d[None, :]).clamp(max=w - 1)                 # (W, D)
    valid = ((xs[:, None] + d[None, :]) < w).T                          # (D, W)
    acc = torch.float32 if low else torch.float64
    out = torch.empty((h, D, w), dtype=torch.float32, device=dev)
    for b0 in range(0, h, R):
        def crops(p):
            strip = p[:, b0:b0 + R + win - 1]
            c = strip.unfold(1, win, 1).unfold(2, win, 1)[:, :, :w]     # (3, R, W, win, win)
            return c.permute(1, 2, 0, 3, 4).reshape(R * w, 3, win, win)

        total = torch.zeros((R, w, D), dtype=acc, device=dev)
        for fl, fr in zip(tower(crops(pl), blocks, low), tower(crops(pr), blocks, low)):
            C, sp = fl.shape[1], fl.shape[2] * fl.shape[3]

            def unit(f):
                f = f.to(acc)
                return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + 1e-10)

            nl, nr = unit(fl).reshape(R, w, -1), unit(fr).reshape(R, w, -1)
            lin = 1.0 / C
            t_l = lin * torch.sum(nl * nl, -1) / sp                      # (R, W)
            t_r = lin * torch.sum(nr * nr, -1) / sp
            a, bt = nr, nl.transpose(1, 2)
            if low:
                a, bt = round_tf32(a), round_tf32(bt)
            cross = lin * torch.bmm(a, bt) / sp                          # (R, W, W)
            total += t_r[:, :, None] + t_l[:, band] - 2.0 * torch.gather(
                cross, 2, band.expand(R, w, D))
        rows = min(R, h - b0)
        out[b0:b0 + rows] = torch.where(valid, total[:rows].transpose(1, 2).to(torch.float32),
                                        math.inf)
    return out


def weight_table(n: int, sigma: float, bias: float, device) -> torch.Tensor:
    """(n + 1,) float32 ``(1 - exp(-k / sigma)) + bias`` at integer k (cell
    8's weight), the exponential taken in float64."""
    k = torch.arange(n + 1, dtype=torch.float32)
    e = torch.exp((-k / sigma).double()).float()
    return ((1.0 - e) + bias).to(device)


def smooth(cost: torch.Tensor, table: torch.Tensor, chunk: int) -> torch.Tensor:
    """Cell 10's chunked smoothing of (H, D, W) costs into (H, W) float32
    argmin indices: row y > 0 weights candidate d by
    ``table[|d - disp[y-1, x]|]``; a pixel that is not the first of its
    chunk also by ``table[|d - min(disp[y, x-1], min(D, W - x))|]``."""
    h, D, w = cost.shape
    dev = cost.device
    d = torch.arange(D, device=dev)[:, None]
    sizes = torch.clamp(w - torch.arange(w, device=dev), max=D)
    out = torch.empty((h, w), dtype=torch.long, device=dev)
    for y in range(h):
        cu = cost[y] if y == 0 else cost[y] * table[(d - out[y - 1]).abs()]
        left = None
        for p in range(min(chunk, w)):
            c = cu[:, p::chunk]
            if p > 0:
                c = c * table[(d - torch.minimum(left[:c.shape[1]], sizes[p::chunk])).abs()]
            left = torch.argmin(c, dim=0)
            out[y, p::chunk] = left
    return out.to(torch.float32)


def table_for(cost: torch.Tensor, pcfg: dict) -> torch.Tensor:
    return weight_table(cost.shape[1], pcfg["smoothing_sigma"], pcfg["smoothing_bias"],
                        cost.device)


def forced_excess(cost: torch.Tensor, table: torch.Tensor, chunk: int,
                  disparity) -> torch.Tensor:
    """(H, W) float64: how far each pixel's chosen candidate in
    ``disparity`` lies above the best one under cell 10's weights, with
    each pixel weighted by the neighbours' choices in ``disparity`` (the
    choices its recurrence saw): ``c[chosen] - min c``; 0 where both are
    +inf, +inf for a choice outside [0, D) or an +inf choice beside a
    finite best."""
    h, D, w = cost.shape
    dev = cost.device
    disp = torch.as_tensor(np.asarray(disparity), device=dev)
    idx = disp.round().long()
    d = torch.arange(D, device=dev)[None, :, None]
    c = cost.clone()
    c[1:] = c[1:] * table[(d - idx[:-1, None, :].clamp(0, D - 1)).abs()]
    sizes = torch.clamp(w - torch.arange(w, device=dev), max=D)
    mean = torch.minimum(idx[:, :-1].clamp(0, D), sizes[1:])         # (H, W - 1)
    follows = (torch.arange(1, w, device=dev) % chunk) != 0          # not first in its chunk
    c[:, :, 1:] = torch.where(follows, c[:, :, 1:] * table[(d - mean[:, None, :]).abs()],
                              c[:, :, 1:])
    best = c.min(dim=1).values.double()
    chosen = c.gather(1, idx.clamp(0, D - 1)[:, None, :])[:, 0].double()
    ok = (idx >= 0) & (idx < D) & (disp == idx.to(disp.dtype))
    excess = torch.where(chosen == best, 0.0, chosen - best)
    return torch.where(ok, excess, math.inf)
