"""The pose layer's SIFT scale-space kernels (``csrc/sift.cuh``) and their launcher.

The kernels replace no TPU kernel (JAX's ``ops/features.py`` builds the
scale space from matmuls and XLA elementwise ops). They make the dense part
of ``ops/features.py``'s detection, whose plain twin
(``scale_space_plain`` with ``blur_in_tap_order``) is ~1,800 small ops a
request of two 750x900 images, 1 + (s + 2) launches of ``level`` and one of
``detect`` an octave: 25 at the default ``FrontendConfig``. Their planes
equal the twin's bit for bit.

``level`` writes one Gaussian level of a batch of images, each output the
sum of its 2r + 1 taps' products in tap order, rows first, with reflect-101
borders; ``detect`` writes one octave's DoG planes, extremum response and
gradient planes. ``ops/features.py`` picks the route by device
(``kernels/launch.py::on_card``) and calls these for tensors on one CUDA
device only; they launch or raise.
"""

from __future__ import annotations

import ctypes

import torch

from stereo_reconstruction_tpu_torch.kernels.launch import entry, launch

_p, _i = ctypes.c_void_p, ctypes.c_int
_level = entry("stpu_sift_level", [_p, _p, _p, _p], _i)
_detect = entry("stpu_sift_detect", [_p, _p, _p, _p], _i)

MAX_RADIUS = 24      # csrc/sift.cuh kMaxRadius: a level's halo in 35 KB of shared memory
MAX_SCALES = 7       # csrc/sift.cuh kMaxScales: an octave's 2s + 5 halo planes in 48 KB
MAX_SIDE = 1 << 20


def call_level(src: torch.Tensor, taps, dst: torch.Tensor, copy, stream) -> int:
    """``stpu_sift_level`` on views of one device; its return code. ``src``
    is (B, H, W) with any strides; ``dst`` and ``copy`` (or None) are (B, H,
    W) with contiguous rows."""
    B, H, W = src.shape
    ptrs = (ctypes.c_void_p * 3)(src.data_ptr(), dst.data_ptr(),
                                 None if copy is None else copy.data_ptr())
    dims = (ctypes.c_longlong * 8)(B, H, W, *src.stride(), dst.stride(0), (len(taps) - 1) // 2)
    return _level(ptrs, dims, (ctypes.c_float * len(taps))(*taps), stream)


def level(src: torch.Tensor, taps, dst: torch.Tensor, copy=None) -> None:
    """One Gaussian level in one launch on the current stream: ``dst[b]`` =
    ``blur_in_tap_order(src[b])`` with the 2r + 1 float32 ``taps``, and
    ``copy[b] = src[b]`` where ``copy`` is given. ``src`` is (B, H, W)
    float32 with any strides (a stack's strided plane); ``dst`` and ``copy``
    are (B, H, W) float32 with contiguous rows and one batch stride (a
    stack's planes), on the device of ``src``. Raises ValueError where the
    kernel cannot hold the radius (1 to MAX_RADIUS) or the plane (sides
    above the radius, as ``F.pad(mode="reflect")`` asks, up to MAX_SIDE)."""
    for name, t in (("src", src), ("dst", dst), ("copy", copy)):
        if t is not None and (t.ndim != 3 or t.shape != src.shape or t.dtype != torch.float32
                              or t.device != src.device):
            raise ValueError(f"{name} must be a (B, H, W) float32 tensor like src, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    B, H, W = src.shape
    for name, t in (("dst", dst), ("copy", copy)):
        if t is not None and (t.stride(0), t.stride(1), t.stride(2)) != (dst.stride(0), W, 1):
            raise ValueError(f"{name} must have contiguous rows and dst's batch stride, got "
                             f"strides {t.stride()}")
    radius = (len(taps) - 1) // 2
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"the SIFT level kernel takes radii 1 to {MAX_RADIUS}, got {radius}")
    if not (radius < H <= MAX_SIDE and radius < W <= MAX_SIDE):
        raise ValueError(f"the SIFT level kernel needs planes wider and taller than the radius "
                         f"{radius} (at most {MAX_SIDE}), got {H}x{W}")
    launch("sift", call_level, src.device, src, taps, dst, copy)


def call_detect(gauss, dog, response, mag, ang, first: int, scalars, stream) -> int:
    """``stpu_sift_detect`` on contiguous tensors of one device; its return
    code."""
    B, planes, H0, W0 = mag.shape
    _, n, oh, ow = gauss.shape
    ptrs = (ctypes.c_void_p * 5)(*(t.data_ptr() for t in (gauss, dog, response, mag, ang)))
    dims = (ctypes.c_int * 8)(B, n - 3, oh, ow, H0, W0, planes, first)
    return _detect(ptrs, dims, (ctypes.c_float * 3)(*scalars), stream)


def detect(gauss: torch.Tensor, dog: torch.Tensor, response: torch.Tensor, mag: torch.Tensor,
           ang: torch.Tensor, first: int, contrast: float, edge: float) -> None:
    """One octave's detection planes in one launch on the current stream.
    From the contiguous (B, s + 3, oh, ow) Gaussian stack it writes the DoG
    planes 1..s and their extremum response into the contiguous (B, s, oh,
    ow) ``dog`` and ``response``, and the gradient magnitude and angle of
    the Gaussian planes 1..s into the (oh, ow) corner of slots ``first`` ..
    ``first + s - 1`` of the contiguous (B, planes, H0, W0) ``mag`` and
    ``ang``; it writes nothing else of them. ``contrast`` is the response's threshold (``contrast_threshold /
    s``), ``edge`` the Hessian ratio; both are rounded to float32, as
    PyTorch rounds a Python scalar beside a float32 tensor."""
    B, n, oh, ow = gauss.shape
    s = n - 3
    if not 1 <= s <= MAX_SCALES:
        raise ValueError(f"the SIFT detection kernel takes 1 to {MAX_SCALES} scales an octave, "
                         f"got {s}")
    want = {"dog": (dog, (B, s, oh, ow)), "response": (response, (B, s, oh, ow)),
            "ang": (ang, tuple(mag.shape))}
    for name, (t, shape) in (("gauss", (gauss, (B, n, oh, ow))), *want.items(),
                             ("mag", (mag, tuple(mag.shape)))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != gauss.device:
            raise ValueError(f"{name} must be a contiguous float32 {shape} on {gauss.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if mag.ndim != 4 or mag.shape[0] != B or not (oh <= mag.shape[2] and ow <= mag.shape[3]) \
            or not 0 <= first <= mag.shape[1] - s:
        raise ValueError(f"mag must hold slots {first}..{first + s - 1} of (B, H0, W0) planes "
                         f"at least {oh}x{ow}, got {tuple(mag.shape)}")
    launch("sift", call_detect, gauss.device, gauss, dog, response, mag, ang, first,
           (contrast, edge, (edge + 1.0) ** 2))
