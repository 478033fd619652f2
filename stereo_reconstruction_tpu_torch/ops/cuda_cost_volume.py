"""K1 and K2, the Right-variant SSD cost kernels, their plain PyTorch
twins, and the wrappers that pick between them by device.

Both replace ``stereo_reconstruction_tpu/ops/pallas_cost_volume.py::_kernel``
and both are sinks of one window-cost routine (``csrc/window_cost.cuh``):

* K1 (``csrc/matcher_inputs.cuh``), mode ``"inputs"``
  (``pallas_matcher_inputs``): the cost of every disparity plane is folded
  on the fly into the five (H, W) planes of the exact smoothing scan
  (``ops/smoothing.py``), so the (D, H, W) volume is never written.
  Wrapper ``matcher_inputs``, count ``LAUNCHES["K1"]``.
* K2 (``csrc/cost_volume.cuh``), mode ``"volume"``
  (``pallas_cost_volume_right_ssd``): the full (D, H, W) volume, +inf =
  invalid. Wrapper ``cost_volume``, count ``LAUNCHES["K2"]``; its twin is
  ``ops/cost_volume.py::cost_volume_right_ssd``.

Each call is one launch of its count: the left image's layout pass and the
kernel. Both take block sizes up to 17 (``hbs <= 8``, as the TPU kernel's
24-row bands; the limit is read from the kernel library) and raise
``ValueError`` beyond. The routine adds in one order for every sink, so
``volume_reductions`` of K2's volume equals K1's planes bit for bit on any
input.

The routine's left layout holds 3·H·WLp floats, ``WLp = max(W_l, W +
min_d + D)``, indexed in 32 bits: a call with 3·H·WLp at or past 2^31 - 1
raises ``ValueError`` before any launch (``check_limits``; the library
refuses it as well).

Both take ``row_offset`` / ``total_height`` (the TPU kernel's ``geom``
input ``[row0, H_total]``): the images are then a row tile of an image
``total_height`` rows tall, whose local row 0 is global row ``row_offset``
(the sharded matcher's halo-extended tiles, ``parallel/sharded.py``). A
whole image is ``row_offset = 0, total_height = H``, the default, and runs
the same kernel code. ``check_limits`` applies to the tile's own shape.

A wrapper takes the plain twin only for CPU tensors. A CUDA tensor
launches the kernel or raises; nothing falls back. ``min_disparity < 0``
raises ``ValueError`` on every device.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_reconstruction_tpu_torch.kernels.launch import entry, launch, on_card
from stereo_reconstruction_tpu_torch.ops.cost_volume import cost_volume_right_ssd
from stereo_reconstruction_tpu_torch.ops.smoothing import volume_reductions

_p, _i = ctypes.c_void_p, ctypes.c_int
_matcher_inputs = entry("stpu_matcher_inputs", [_p] * 8 + [_i] * 9 + [_p], _i)
_cost_volume = entry("stpu_cost_volume", [_p] * 4 + [_i] * 9 + [_p], _i)
_max_hbs = entry("stpu_matcher_inputs_max_hbs", [], _i)


def matcher_inputs_plain(left, right, block_size: int = 17,
                         min_disparity: int = 0, max_disparity: int = 200,
                         row_offset=None, total_height=None):
    """(m0, a0, c_zero, diag_up, diag_lf) from the full plain cost volume."""
    cost = cost_volume_right_ssd(left, right, block_size, min_disparity,
                                 max_disparity, row_offset, total_height)
    return volume_reductions(cost, min_disparity)


def _global_rows(right, row_offset, total_height):
    """The kernels' (row0, H_total): the whole image when not given."""
    h = right.shape[0]
    row0 = 0 if row_offset is None else int(row_offset)
    total = h if total_height is None else int(total_height)
    if total < 1:
        raise ValueError(f"total_height must be >= 1, got {total}")
    return row0, total


def matcher_inputs(left, right, block_size: int = 17,
                   min_disparity: int = 0, max_disparity: int = 200,
                   row_offset=None, total_height=None):
    """The five smoothing-scan inputs for left (H, W_l, 3) and right
    (H, W, 3) images: the plain twin for CPU tensors, K1 for CUDA tensors.
    uint8 images are cast to float32. ``row_offset`` / ``total_height``:
    global rows (module docstring)."""
    if not on_card("K1", left, right):
        return matcher_inputs_plain(left, right, block_size, min_disparity,
                                    max_disparity, row_offset, total_height)
    row0, total = _global_rows(right, row_offset, total_height)
    left, right, D = cuda_images(left, right, min_disparity, max_disparity, "K1")
    hbs, wl_pad, scratch = window_cost_setup(left, right, block_size, min_disparity, D, "K1")
    h, w = right.shape[:2]
    f32 = dict(dtype=torch.float32, device=right.device)
    m0 = torch.empty((h, w), **f32)
    a0 = torch.empty((h, w), dtype=torch.int32, device=right.device)
    cz = torch.empty((h, w), **f32)
    du = torch.empty((h, w), **f32)
    dl = torch.empty((h, w), **f32)
    launch("K1", _matcher_inputs, right.device,
           left.data_ptr(), right.data_ptr(), m0.data_ptr(), a0.data_ptr(),
           cz.data_ptr(), du.data_ptr(), dl.data_ptr(), scratch.data_ptr(),
           h, w, left.shape[1], wl_pad, hbs, min_disparity, D, row0, total)
    return m0, a0, cz, du, dl


def cost_volume(left, right, block_size: int = 17, min_disparity: int = 0,
                max_disparity: int = 200, row_offset=None, total_height=None):
    """The (D, H, W) float32 Right-SSD cost volume (+inf = invalid) of left
    (H, W_l, 3) and right (H, W, 3) images: the plain twin
    ``cost_volume_right_ssd`` for CPU tensors (any block size), K2 for CUDA
    tensors (block sizes up to 17, as K1 and the TPU kernel; ``ValueError``
    beyond; no caller in the port passes more). ``row_offset`` /
    ``total_height``: global rows (module docstring)."""
    if not on_card("K2", left, right):
        return cost_volume_right_ssd(left, right, block_size, min_disparity,
                                     max_disparity, row_offset, total_height)
    row0, total = _global_rows(right, row_offset, total_height)
    left, right, D = cuda_images(left, right, min_disparity, max_disparity, "K2")
    hbs, wl_pad, scratch = window_cost_setup(left, right, block_size, min_disparity, D, "K2")
    h, w = right.shape[:2]
    cost = torch.empty((D, h, w), dtype=torch.float32, device=right.device)
    launch("K2", _cost_volume, right.device,
           left.data_ptr(), right.data_ptr(), cost.data_ptr(), scratch.data_ptr(),
           h, w, left.shape[1], wl_pad, hbs, min_disparity, D, row0, total)
    return cost


# the largest 3·H·WLp the window-cost routine's 32-bit indices take
# (``layout_fits``, csrc/window_cost.cuh)
LAYOUT_LIMIT = 2**31 - 1


def check_limits(h: int, w: int, wl: int, min_disparity: int, D: int, kernel: str,
                 max_planes=None) -> None:
    """Raise ``ValueError`` naming the limit where a kernel's library would
    refuse the call: D above ``max_planes`` (K3: 65535) or a left layout of
    3·H·WLp floats at or past 2^31 - 1."""
    if max_planes is not None and D > max_planes:
        raise ValueError(f"{kernel} takes D <= {max_planes} disparity planes, got D = {D} "
                         f"(backend='xla' takes any)")
    wl_pad = max(wl, w + min_disparity + D)
    if 3 * h * wl_pad >= LAYOUT_LIMIT:
        raise ValueError(f"{kernel} needs 3·H·WLp < 2^31 - 1 (its 32-bit layout indices), "
                         f"got 3·{h}·{wl_pad} = {3 * h * wl_pad}, WLp = max(W_l, W + min_d "
                         f"+ D) (backend='xla' takes any)")


def cuda_images(left, right, min_disparity: int, max_disparity: int, kernel: str,
                max_planes=None):
    """Check a kernel's image pair (on one CUDA device: ``on_card``),
    disparity range and limits (``check_limits``); return the images as
    contiguous float32 and the number of planes D."""
    if left.ndim != 3 or right.ndim != 3 or left.shape[2] != 3 or right.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) images, got {tuple(left.shape)} "
                         f"and {tuple(right.shape)}")
    if left.shape[0] != right.shape[0]:
        raise ValueError(f"image heights differ: {left.shape[0]} vs {right.shape[0]}")
    if min_disparity < 0:
        raise ValueError(f"{kernel} needs min_disparity >= 0")
    D = max_disparity - min_disparity
    if D <= 0:
        raise ValueError(f"empty disparity range [{min_disparity}, {max_disparity})")
    check_limits(right.shape[0], right.shape[1], left.shape[1], min_disparity, D, kernel,
                 max_planes)
    return (left.to(torch.float32).contiguous(),
            right.to(torch.float32).contiguous(), D)


def window_cost_setup(left, right, block_size: int, min_disparity: int, D: int,
                      kernel: str):
    """hbs and the scratch of the window-cost routine's layout pass: the
    left image as float2 + float planes zero-padded to ``wl_pad = max(W_l,
    W + min_d + D)`` columns (``csrc/window_cost.cuh``). Raises
    ``ValueError`` for a block size the routine does not take."""
    hbs, max_hbs = (block_size - 1) // 2, _max_hbs()
    if not 0 <= hbs <= max_hbs:
        raise ValueError(f"{kernel} takes block sizes up to {2 * max_hbs + 1}, got "
                         f"{block_size} (backend='xla' takes any)")
    h, w = right.shape[:2]
    wl_pad = max(left.shape[1], w + min_disparity + D)
    scratch = torch.empty((3 * h * wl_pad,), dtype=torch.float32, device=right.device)
    return hbs, wl_pad, scratch
