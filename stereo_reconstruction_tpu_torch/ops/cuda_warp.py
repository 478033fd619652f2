"""The perspective warp kernel (``csrc/warp.cuh``) and its launcher.

The kernel replaces no TPU kernel: it makes one launch of each batch of
warps that the plain twin, ``ops/warp.py::warp_inverse_map``, spreads over
~100 small ops an image (bilinear; ~40 nearest), and it equals the twin bit
for bit. It takes several sources a launch, each with its own shape and
inverse map, so a pair's two rectifying warps are one launch.

The inverse maps never touch the card: the caller inverts H in float32 on
the host (``ops/warp.py::host_inverse``), and the nine floats of each map
go to the kernel by value, as its launch argument. So a warp of
device-resident images neither uploads nor synchronises, and a card warp
equals the CPU path's bit for bit.

``ops/warp.py::warp_inverse_maps`` picks the route by device and calls
``warp`` for images on one CUDA device only; ``warp`` launches or raises.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from stereo_reconstruction_tpu_torch.kernels.launch import entry, launch

_p, _i = ctypes.c_void_p, ctypes.c_int
_warp = entry("stpu_warp", [_p, _p, _p, _i, _i, _i, _p, _i, _i, _i, _p], _i)
_max_images = entry("stpu_warp_max_images", [], _i)


def warp(
    images: List[torch.Tensor],       # B images (h, w) or (h, w, C), one CUDA device
    Hinv: torch.Tensor,               # (B, 3, 3) float32 on the CPU: DEST -> SOURCE
    out_shape: Tuple[int, int],
    method: str = "bilinear",
) -> torch.Tensor:
    """(B, h_out, w_out[, C]) float32, ``warp_inverse_map`` of each image
    with its map, in one launch a ``stpu_warp_max_images()`` images. Takes
    what the twin takes: any dtype (uint8 and float32 read as they are,
    others converted to float32 first, as the twin converts them), any
    layout and any channel count (1 and 3 in the kernel's pixel loop, others
    a plane a channel)."""
    if method not in ("bilinear", "nearest"):
        raise ValueError(f"unknown warp method {method!r}")
    if Hinv.device.type != "cpu" or Hinv.dtype != torch.float32:
        raise ValueError(f"the maps must be float32 on the CPU, got {Hinv.dtype} on "
                         f"{Hinv.device}")
    if images[0].ndim not in (2, 3):
        raise ValueError(f"images must be (h, w) or (h, w, C), got {tuple(images[0].shape)}")
    if any(img.dtype != torch.uint8 for img in images):
        images = [img.to(torch.float32) for img in images]
    images = [img.contiguous() for img in images]
    channels = 1 if images[0].ndim == 2 else images[0].shape[2]
    if channels in (1, 3):
        return _launch(images, Hinv, out_shape, method, channels)
    # another channel count: each channel a single-channel image of its own
    n = len(images)
    planes = [p.contiguous() for img in images for p in img.unbind(2)]
    out = _launch(planes, Hinv.repeat_interleave(channels, 0), out_shape, method, 1)
    return out.view(n, channels, *out.shape[1:]).movedim(1, -1).contiguous()


def _launch(images, Hinv, out_shape, method, channels) -> torch.Tensor:
    for img in images:
        if img.numel() == 0 or img.numel() >= 2 ** 31:
            raise ValueError(f"the warp kernel needs non-empty images under 2**31 entries, "
                             f"got {tuple(img.shape)}")
    h_out, w_out = (int(n) for n in out_shape)
    if not (1 <= h_out <= 65535 * 4 and w_out >= 1):
        raise ValueError(f"out_shape must be positive (h_out <= 262140), got {out_shape}")
    n, first, device = len(images), images[0], images[0].device
    srcs = (ctypes.c_void_p * n)(*(img.data_ptr() for img in images))
    shapes = (ctypes.c_int * (2 * n))(*(int(s) for img in images for s in img.shape[:2]))
    maps = Hinv.contiguous()
    out = torch.empty((n, h_out, w_out, *first.shape[2:]), dtype=torch.float32, device=device)
    launch("warp", _warp, device, srcs, shapes, maps.data_ptr(), n,
           int(first.dtype == torch.uint8), channels, out.data_ptr(), h_out, w_out,
           int(method == "nearest"), count=-(-n // _max_images()))
    return out
