"""Dense matching-cost volumes, plain PyTorch.

Port of ``stereo_reconstruction_tpu/ops/cost_volume.py`` (reference
``BlockSearch.cpp:24-179``): the Right-variant SSD, SAD and NCC volumes and
the Left-variant SSD volume. The reference's clipped Right-variant window
``[y-up, y+down) x [x-left, x+right)`` is the fixed half-open window
``[y-hbs, y+hbs) x [x-hbs, x+hbs)`` intersected with ``[0, H-1) x
[0, W-1)``: zero the last row and column of the difference image, then
take fixed zero-padded window sums. Window sums of integer-valued inputs
are exact in float32 below 2^24 under any summation order, so this
version, the JAX one and the CUDA kernel agree bit for bit there.

The NCC volume sums non-integer values (intensities, their squares and
products), where the order of the additions decides the rounding: its
window sums add the window's terms one by one from its first row and
column, the order of XLA's ``reduce_window``, so it too equals the JAX
package's volume bit for bit on the CPU.

Cost layout is ``(D, H, W)`` float32, ``+inf`` = invalid candidate; every
volume is built ``D_CHUNK`` planes at a time.

``cost_volume_right_ssd(row_offset=, total_height=)`` takes the images as
a row tile of a taller image (the sharded matcher's halo-extended tiles,
``parallel/sharded.py``): the window is clipped to global rows and the
area counts them, so every row the tile holds with its window support
equals the whole image's, as in JAX (``ops/cost_volume.py:117-148``).
"""

from __future__ import annotations

import torch

# disparity planes built per pass: bounds the temporaries to D_CHUNK planes
D_CHUNK = 32


def right_window_geometry(h: int, w: int, block_size: int, device=None):
    """Per-pixel clipped window extents and area for the Right variant."""
    hbs = (block_size - 1) // 2
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    up = ys.clamp(max=hbs)
    down = (h - 1 - ys).clamp(max=hbs)
    left = xs.clamp(max=hbs)
    right = (w - 1 - xs).clamp(max=hbs)
    area = ((left + right)[None, :] * (up + down)[:, None]).to(torch.float32)
    return left, right, up, down, area


def global_row_geometry(h: int, w: int, block_size: int, row_offset: int,
                        total_height: int, device=None):
    """``right_window_geometry`` for local rows ``row_offset .. row_offset +
    h - 1`` of an image ``total_height`` rows tall: (right extents, area,
    row_valid). The area counts global rows and is 0 on rows outside the
    image; ``row_valid`` marks the rows inside [0, total_height - 1), the
    rows a window may hold."""
    hbs = (block_size - 1) // 2
    ys = row_offset + torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    up = ys.clamp(max=hbs).clamp(min=0)
    down = (total_height - 1 - ys).clamp(max=hbs).clamp(min=0)
    in_img = (ys >= 0) & (ys < total_height)
    left = xs.clamp(max=hbs)
    right = (w - 1 - xs).clamp(max=hbs)
    area = ((left + right)[None, :] * torch.where(in_img, up + down, 0)[:, None]
            ).to(torch.float32)
    return right, area, (ys >= 0) & (ys < total_height - 1)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt, like IEEE ``sqrtf`` (and XLA's and
    the kernel's). PyTorch's vectorised CPU sqrt is off by one ulp on a
    fraction of inputs; a float64 sqrt rounded once to float32 is exact
    (53 >= 2 * 24 + 2 bits, so the double rounding is innocuous)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _sliding_sum(x: torch.Tensor, size: int, before: int, dim: int) -> torch.Tensor:
    """out[i] = sum_{k=-before}^{size-1-before} x[i+k] along ``dim``, zeros
    outside, as a doubling tree of shifted adds (O(log size) passes)."""
    n = x.shape[dim]
    pad = [0, 0] * (x.ndim - 1 - dim) + [before, size - 1 - before]
    p = torch.nn.functional.pad(x, pad)        # length n + size - 1 along dim
    sums = {1: p}
    q = 1
    while q * 2 <= size:
        s = sums[q]
        m = s.shape[dim]
        sums[q * 2] = s.narrow(dim, 0, m - q) + s.narrow(dim, q, m - q)
        q *= 2
    out, off, bit = None, 0, q
    while bit >= 1:
        if size & bit:
            term = sums[bit].narrow(dim, off, n)
            out = term if out is None else out + term
            off += bit
        bit //= 2
    return out


def _sliding_sum_in_order(x: torch.Tensor, size: int, before: int,
                          dim: int) -> torch.Tensor:
    """``_sliding_sum`` adding the window's terms one by one from its first
    (``size`` passes): the rounding of XLA's ``reduce_window``."""
    n = x.shape[dim]
    pad = [0, 0] * (x.ndim - 1 - dim) + [before, size - 1 - before]
    p = torch.nn.functional.pad(x, pad)
    out = p.narrow(dim, 0, n).clone()
    for k in range(1, size):
        out += p.narrow(dim, k, n)
    return out


def clipped_window_sum(plane: torch.Tensor, hbs: int, in_order: bool = False,
                       row_valid=None) -> torch.Tensor:
    """Sum of ``plane`` (..., H, W) over [y-hbs, y+hbs) x [x-hbs, x+hbs)
    clipped to [0, H-1) x [0, W-1), for every pixel; rows first, then
    columns. ``in_order`` adds each window's terms in order (for
    non-integer planes, whose sums depend on it). ``row_valid`` (H,) bool
    replaces the rows [0, H-1) (a row tile's global rows)."""
    h, w = plane.shape[-2:]
    if hbs <= 0:
        return torch.zeros_like(plane)
    masked = plane.clone()
    if row_valid is None:
        masked[..., h - 1, :] = 0
    else:
        masked[..., ~row_valid, :] = 0
    masked[..., :, w - 1] = 0
    sliding = _sliding_sum_in_order if in_order else _sliding_sum
    out = sliding(masked, 2 * hbs, hbs, plane.ndim - 2)
    return sliding(out, 2 * hbs, hbs, plane.ndim - 1)


def _full_window_sum(plane: torch.Tensor, block_size: int) -> torch.Tensor:
    """Sum over the full centred block_size x block_size window (Left
    variant), zero-padded (only interior pixels are consumed)."""
    hbs = (block_size - 1) // 2
    out = _sliding_sum(plane, block_size, hbs, plane.ndim - 2)
    return _sliding_sum(out, block_size, hbs, plane.ndim - 1)


def _right_volume(left, right, block_size, min_disparity, max_disparity, plane_costs,
                  geometry=None):
    """The frame every Right-variant volume shares: ``plane_costs(ds, n)``
    returns the (len(ds), H, W) costs of the disparities ``ds`` (``n`` is
    the clipped window area, at least 1); they are kept where the
    candidate ``x + d + right < W_l`` exists (the break at
    BlockSearch.cpp:148-149) and the window area is positive, else +inf.
    ``geometry`` (right extents, area) replaces the whole image's."""
    if min_disparity < 0:
        raise ValueError("min_disparity < 0 is not supported")
    h, w = right.shape[:2]
    if left.shape[0] != h:
        raise ValueError(f"image heights differ: {left.shape[0]} vs {h}")
    w_l = left.shape[1]
    D = max_disparity - min_disparity
    device = right.device
    if geometry is None:
        _, right_ext, _, _, area = right_window_geometry(h, w, block_size, device)
    else:
        right_ext, area = geometry
    pos_area = area > 0
    n = area.clamp(min=1.0)
    reach = torch.arange(w, device=device) + right_ext      # (W,)
    out = torch.empty((D, h, w), dtype=torch.float32, device=device)
    for c0 in range(0, D, D_CHUNK):
        ds = range(min_disparity + c0, min_disparity + min(c0 + D_CHUNK, D))
        dcol = torch.tensor(list(ds), device=device)[:, None, None]
        valid = ((reach[None, None, :] + dcol) < w_l) & pos_area
        out[c0:c0 + len(ds)] = torch.where(valid, plane_costs(ds, n), float("inf"))
    return out


def _padded_left(left: torch.Tensor, w: int, max_disparity: int) -> torch.Tensor:
    """``left`` zero-padded on the right so L[:, x + d] is a plain slice
    for every d < max_disparity and x < w."""
    pad_w = max(0, w + max_disparity - left.shape[1])
    pad = (0, 0, 0, pad_w) if left.ndim == 3 else (0, pad_w)
    return torch.nn.functional.pad(left, pad)


def cost_volume_right_ssd(
    left: torch.Tensor,    # (H, W_l, 3) float32
    right: torch.Tensor,   # (H, W, 3) float32
    block_size: int = 17,
    min_disparity: int = 0,
    max_disparity: int = 200,
    row_offset=None,       # global index of local row 0
    total_height=None,     # global image height
) -> torch.Tensor:
    """Right-variant SSD cost volume, shape (D, H, W), +inf = invalid.

    Plane ``j`` holds disparity ``d = min_disparity + j``: cost
    ``sqrt(window SSD) * (1 / area)`` (BlockSearch.cpp:158).

    ``row_offset``/``total_height`` take the images as rows ``row_offset
    ..`` of an image ``total_height`` rows tall (rows outside the image
    must hold zeros): window clipping and area use global rows, so a
    halo-extended tile's rows equal the whole image's. Rows outside the
    local images read as zero: where ``row_offset > 0`` (or the tile ends
    above the image bottom) the first (last) ``2 * hbs`` rows see that
    padding as image, and the caller drops them.
    """
    left, right = left.to(torch.float32), right.to(torch.float32)
    h, w = right.shape[:2]
    hbs = (block_size - 1) // 2
    left_p = _padded_left(left, w, max_disparity)
    geometry = row_valid = None
    if row_offset is not None:
        total = h if total_height is None else int(total_height)
        right_ext, area, row_valid = global_row_geometry(
            h, w, block_size, int(row_offset), total, right.device)
        geometry = (right_ext, area)

    def plane_costs(ds, n):
        shifted = torch.stack([left_p[:, d:d + w] for d in ds])   # (Dc, H, W, 3)
        sq = (shifted - right) ** 2
        win = clipped_window_sum(sq[..., 0] + sq[..., 1] + sq[..., 2], hbs,
                                 row_valid=row_valid)
        return sqrt_rn(win.clamp(min=0.0)) * (1.0 / n)

    return _right_volume(left, right, block_size, min_disparity, max_disparity,
                         plane_costs, geometry)


def cost_volume_right_sad(
    left: torch.Tensor,    # (H, W_l, 3) float32
    right: torch.Tensor,   # (H, W, 3) float32
    block_size: int = 17,
    min_disparity: int = 0,
    max_disparity: int = 200,
) -> torch.Tensor:
    """Right-variant SAD cost volume, shape (D, H, W), +inf = invalid: the
    window sum of per-channel |diff| times 1 / area (a framework extension;
    the reference matcher is SSD-only)."""
    left, right = left.to(torch.float32), right.to(torch.float32)
    w = right.shape[1]
    hbs = (block_size - 1) // 2
    left_p = _padded_left(left, w, max_disparity)

    def plane_costs(ds, n):
        shifted = torch.stack([left_p[:, d:d + w] for d in ds])
        a = (shifted - right).abs()
        return clipped_window_sum(a[..., 0] + a[..., 1] + a[..., 2], hbs) * (1.0 / n)

    return _right_volume(left, right, block_size, min_disparity, max_disparity,
                         plane_costs)


def cost_volume_right_ncc(
    left: torch.Tensor,    # (H, W_l, 3) float32
    right: torch.Tensor,   # (H, W, 3) float32
    block_size: int = 17,
    min_disparity: int = 0,
    max_disparity: int = 200,
) -> torch.Tensor:
    """Right-variant zero-normalised cross-correlation cost, (D, H, W):
    ``1 - ZNCC`` over the same clipped windows on the channel mean, range
    [0, 2], +inf = invalid (the BASELINE config-2 cost)."""
    left, right = left.to(torch.float32), right.to(torch.float32)
    w = right.shape[1]
    hbs = (block_size - 1) // 2

    def gray(img):
        # the channel mean as XLA rounds jnp.mean: times float32(1/3)
        return (img[..., 0] + img[..., 1] + img[..., 2]) * (1.0 / 3.0)

    gr = gray(right)
    gl_p = _padded_left(gray(left), w, max_disparity)
    sum_r = clipped_window_sum(gr, hbs, in_order=True)
    sum_r2 = clipped_window_sum(gr * gr, hbs, in_order=True)

    def plane_costs(ds, n):
        var_r = (sum_r2 - sum_r * sum_r / n).clamp(min=0.0)
        sl = torch.stack([gl_p[:, d:d + w] for d in ds])           # (Dc, H, W)
        sum_l = clipped_window_sum(sl, hbs, in_order=True)
        sum_l2 = clipped_window_sum(sl * sl, hbs, in_order=True)
        sum_lr = clipped_window_sum(sl * gr, hbs, in_order=True)
        var_l = (sum_l2 - sum_l * sum_l / n).clamp(min=0.0)
        cov = sum_lr - sum_l * sum_r / n
        denom = sqrt_rn(var_l * var_r)
        ncc = torch.where(denom > 1e-6, cov / denom.clamp(min=1e-6), 0.0)
        return 1.0 - ncc

    return _right_volume(left, right, block_size, min_disparity, max_disparity,
                         plane_costs)


def cost_volume_left_ssd(
    left: torch.Tensor,    # (H, W, 3) float32
    right: torch.Tensor,   # (H, W_r, 3) float32
    block_size: int = 17,
    max_disparity: int = 200,
) -> torch.Tensor:
    """Left-variant SSD cost volume (BlockSearch.cpp:24-86), (D, H, W).

    Plane ``i`` holds disparity ``d = i + 1`` (d = x - correspondX runs
    over [1, max_disparity]): cost ``sqrt(window SSD)`` over full
    block_size windows, valid only where both windows are fully interior.
    """
    left, right = left.to(torch.float32), right.to(torch.float32)
    h, w = left.shape[:2]
    w_r = right.shape[1]
    hbs = (block_size - 1) // 2
    D = max_disparity
    device = left.device
    # right_p[:, max_disparity - d + x] is R[:, x - d]
    right_p = torch.nn.functional.pad(right, (0, 0, max_disparity, max(0, w - w_r)))
    xs = torch.arange(w, device=device)
    ys = torch.arange(h, device=device)
    interior = (((ys[:, None] >= hbs) & (ys[:, None] < h - hbs))
                & ((xs[None, :] >= hbs) & (xs[None, :] < w - hbs)))
    out = torch.empty((D, h, w), dtype=torch.float32, device=device)
    for c0 in range(0, D, D_CHUNK):
        ds = range(1 + c0, 1 + min(c0 + D_CHUNK, D))
        shifted = torch.stack([right_p[:, max_disparity - d:max_disparity - d + w]
                               for d in ds])
        sq = (left - shifted) ** 2
        win = _full_window_sum(sq[..., 0] + sq[..., 1] + sq[..., 2], block_size)
        cx = xs[None, None, :] - torch.tensor(list(ds), device=device)[:, None, None]
        valid = interior & (cx >= hbs) & (cx < w_r - hbs)
        out[c0:c0 + len(ds)] = torch.where(valid, sqrt_rn(win.clamp(min=0.0)),
                                           float("inf"))
    return out


def black_pixel_mask(image: torch.Tensor) -> torch.Tensor:
    """(H, W) bool: pixels that are exactly (0,0,0) — the reference's
    border-skip test (BlockSearch.cpp:105-108)."""
    return (image == 0).all(dim=-1)
