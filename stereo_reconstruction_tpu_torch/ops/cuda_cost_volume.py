"""K1 and K2, the Right-variant SSD cost kernels, their plain PyTorch
twins, and the wrappers that pick between them by device.

Both replace ``stereo_reconstruction_tpu/ops/pallas_cost_volume.py::_kernel``
and both are sinks of one window-cost routine (``csrc/window_cost.cuh``):

* K1 (``csrc/matcher_inputs.cuh``), mode ``"inputs"``
  (``pallas_matcher_inputs``): the cost of every disparity plane is folded
  on the fly into the five (H, W) planes of the exact smoothing scan
  (``ops/smoothing.py``), so the (D, H, W) volume is never written.
  Wrapper ``matcher_inputs``, count ``LAUNCHES``.
* K2 (``csrc/cost_volume.cuh``), mode ``"volume"``
  (``pallas_cost_volume_right_ssd``): the full (D, H, W) volume, +inf =
  invalid. Wrapper ``cost_volume``, count ``VOLUME_LAUNCHES``; its twin is
  ``ops/cost_volume.py::cost_volume_right_ssd``.

Each call is one launch of its count: the left image's layout pass and the
kernel. Both take block sizes up to 17 (``hbs <= 8``, as the TPU kernel's
24-row bands; the limit is read from the kernel library) and raise
``ValueError`` beyond. The routine adds in one order for every sink, so
``volume_reductions`` of K2's volume equals K1's planes bit for bit on any
input.

A wrapper takes the plain twin only for CPU tensors. A CUDA tensor
launches the kernel or raises; nothing falls back. ``min_disparity < 0``
raises ``ValueError`` on every device.
"""

from __future__ import annotations

import torch

from stereo_reconstruction_tpu_torch.ops.cost_volume import cost_volume_right_ssd
from stereo_reconstruction_tpu_torch.ops.smoothing import volume_reductions

# kernel launches made by ``matcher_inputs`` (K1) and ``cost_volume`` (K2);
# the plain twins never count
LAUNCHES = 0
VOLUME_LAUNCHES = 0


def matcher_inputs_plain(left, right, block_size: int = 17,
                         min_disparity: int = 0, max_disparity: int = 200):
    """(m0, a0, c_zero, diag_up, diag_lf) from the full plain cost volume."""
    cost = cost_volume_right_ssd(left, right, block_size, min_disparity,
                                 max_disparity)
    return volume_reductions(cost, min_disparity)


def matcher_inputs(left, right, block_size: int = 17,
                   min_disparity: int = 0, max_disparity: int = 200):
    """The five smoothing-scan inputs for left (H, W_l, 3) and right
    (H, W, 3) images: the plain twin for CPU tensors, K1 for CUDA tensors.
    uint8 images are cast to float32."""
    global LAUNCHES
    if left.device.type == "cpu" and right.device.type == "cpu":
        return matcher_inputs_plain(left, right, block_size, min_disparity,
                                    max_disparity)
    left, right, D = cuda_images(left, right, min_disparity, max_disparity, "K1")
    lib, hbs, wl_pad, scratch = window_cost_setup(left, right, block_size,
                                                  min_disparity, D, "K1")
    h, w = right.shape[:2]
    f32 = dict(dtype=torch.float32, device=right.device)
    m0 = torch.empty((h, w), **f32)
    a0 = torch.empty((h, w), dtype=torch.int32, device=right.device)
    cz = torch.empty((h, w), **f32)
    du = torch.empty((h, w), **f32)
    dl = torch.empty((h, w), **f32)
    stream = torch.cuda.current_stream(right.device).cuda_stream
    with torch.cuda.device(right.device):
        rc = lib.stpu_matcher_inputs(
            left.data_ptr(), right.data_ptr(), m0.data_ptr(), a0.data_ptr(),
            cz.data_ptr(), du.data_ptr(), dl.data_ptr(), scratch.data_ptr(),
            h, w, left.shape[1], wl_pad, hbs, min_disparity, D, stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    LAUNCHES += 1
    return m0, a0, cz, du, dl


def cost_volume(left, right, block_size: int = 17, min_disparity: int = 0,
                max_disparity: int = 200):
    """The (D, H, W) float32 Right-SSD cost volume (+inf = invalid) of left
    (H, W_l, 3) and right (H, W, 3) images: the plain twin
    ``cost_volume_right_ssd`` for CPU tensors (any block size), K2 for CUDA
    tensors (block sizes up to 17, as K1 and the TPU kernel; ``ValueError``
    beyond; no caller in the port passes more)."""
    global VOLUME_LAUNCHES
    if left.device.type == "cpu" and right.device.type == "cpu":
        return cost_volume_right_ssd(left, right, block_size, min_disparity,
                                     max_disparity)
    left, right, D = cuda_images(left, right, min_disparity, max_disparity, "K2")
    lib, hbs, wl_pad, scratch = window_cost_setup(left, right, block_size,
                                                  min_disparity, D, "K2")
    h, w = right.shape[:2]
    cost = torch.empty((D, h, w), dtype=torch.float32, device=right.device)
    stream = torch.cuda.current_stream(right.device).cuda_stream
    with torch.cuda.device(right.device):
        rc = lib.stpu_cost_volume(
            left.data_ptr(), right.data_ptr(), cost.data_ptr(), scratch.data_ptr(),
            h, w, left.shape[1], wl_pad, hbs, min_disparity, D, stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    VOLUME_LAUNCHES += 1
    return cost


def cuda_images(left, right, min_disparity: int, max_disparity: int, kernel: str):
    """Check a kernel's image pair and disparity range; return the images
    as contiguous float32 and the number of planes D."""
    if left.device != right.device or left.device.type != "cuda":
        raise ValueError(
            f"{kernel} needs both images on one CUDA device, got {left.device} "
            f"and {right.device}")
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
    return (left.to(torch.float32).contiguous(),
            right.to(torch.float32).contiguous(), D)


def window_cost_setup(left, right, block_size: int, min_disparity: int, D: int,
                      kernel: str):
    """The kernel library, hbs, and the scratch of the window-cost routine's
    layout pass: the left image as float2 + float planes zero-padded to
    ``wl_pad = max(W_l, W + min_d + D)`` columns (``csrc/window_cost.cuh``).
    Raises ``ValueError`` for a block size the routine does not take."""
    from stereo_reconstruction_tpu_torch.kernels.build import load_library

    lib = load_library()
    hbs, max_hbs = (block_size - 1) // 2, lib.stpu_matcher_inputs_max_hbs()
    if not 0 <= hbs <= max_hbs:
        raise ValueError(f"{kernel} takes block sizes up to {2 * max_hbs + 1}, got "
                         f"{block_size} (backend='xla' takes any)")
    h, w = right.shape[:2]
    wl_pad = max(left.shape[1], w + min_disparity + D)
    scratch = torch.empty((3 * h * wl_pad,), dtype=torch.float32, device=right.device)
    return lib, hbs, wl_pad, scratch
