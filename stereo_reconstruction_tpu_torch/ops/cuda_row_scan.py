"""K1b, the exact smoothing row scan (``csrc/row_scan.cuh``), and the
wrapper that picks between it and its plain twin by device.

K1b replaces the ``lax.scan`` of ``stereo_reconstruction_tpu/ops/
smoothing.py::smoothed_argmin_from_inputs``: from K1's five planes and the
black mask it runs the Right variant's smoothing recurrence row by row, in
one launch of one thread-block cluster whose warps each own a strip of
columns and hand the left-neighbour case on to the strip to their right.
Its plain twin is ``ops/smoothing.py::smoothed_argmin_from_inputs``
(a Python loop over rows); the two agree bit for bit on any input.

Both take ``first_flags`` (the rows with no up neighbour) and ``init_prev``
(row 0's up neighbour where its flag is clear), JAX's arguments for the
sharded matcher's seeded row tiles; without them row 0 alone is first and
the seed is 0.

The wrapper takes the twin only for CPU tensors. CUDA tensors launch the
kernel or raise (a refused or failed cluster launch raises
``RuntimeError`` with the CUDA error's name); nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from stereo_reconstruction_tpu_torch.kernels.launch import entry, launch, on_card
from stereo_reconstruction_tpu_torch.ops.smoothing import smoothed_argmin_from_inputs

_p, _i = ctypes.c_void_p, ctypes.c_int
_row_scan = entry("stpu_row_scan", [_p] * 9 + [_i, _i, ctypes.c_float, _i, _i, _p], _i)
_max_width = entry("stpu_row_scan_max_width", [], _i)


def max_width() -> int:
    """The widest row K1b takes (8 CTAs x 16 strips x 64 columns), as the
    kernel library defines it; builds the library on first use."""
    return _max_width()


def row_scan(
    m0: torch.Tensor,          # (H, W) float32 min over D
    a0: torch.Tensor,          # (H, W) int32 first-argmin plane index
    c_zero: torch.Tensor,      # (H, W) float32 the d == 0 plane
    diag_up: torch.Tensor,     # (H, W) float32 cost[x - d_first]
    diag_lf: torch.Tensor,     # (H, W) float32 cost[x - 1 - d_first]
    black: torch.Tensor,       # (H, W) bool (or uint8)
    smooth_factor: float = 0.9,
    d_first: int = 0,
    n_planes: int = 1,
    first_flags: Optional[torch.Tensor] = None,   # (H,) bool
    init_prev: Optional[torch.Tensor] = None,     # (W,) float32
) -> torch.Tensor:
    """The (H, W) float32 disparity of the exact smoothing scan: the plain
    twin for CPU tensors, K1b for CUDA tensors."""
    planes = (m0, a0, c_zero, diag_up, diag_lf, black)
    if not on_card("K1b", *planes, first_flags, init_prev):
        return smoothed_argmin_from_inputs(
            m0, a0, c_zero, diag_up, diag_lf, black, smooth_factor=smooth_factor,
            d_first=d_first, n_planes=n_planes, first_flags=first_flags,
            init_prev=init_prev)
    if m0.ndim != 2 or any(t.shape != m0.shape for t in planes):
        raise ValueError(f"expected six (H, W) planes, got {[tuple(t.shape) for t in planes]}")
    for name, t in zip(("m0", "c_zero", "diag_up", "diag_lf"), (m0, c_zero, diag_up, diag_lf)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if a0.dtype != torch.int32:
        raise ValueError(f"a0 must be int32, got {a0.dtype}")
    if black.dtype == torch.bool:
        black = black.view(torch.uint8)
    if black.dtype != torch.uint8:
        raise ValueError(f"black must be bool or uint8, got {black.dtype}")
    if not all(t.is_contiguous() for t in (m0, a0, c_zero, diag_up, diag_lf, black)):
        raise ValueError("K1b needs contiguous planes")
    h, w = m0.shape
    if not 1 <= w <= max_width() or h < 1:
        raise ValueError(f"K1b takes 1 <= W <= {max_width()} and H >= 1, got {h}x{w} "
                         "(backend='xla' takes any)")
    if d_first < 0 or n_planes < 1:
        raise ValueError(f"K1b needs d_first >= 0 and n_planes >= 1, got "
                         f"{d_first}, {n_planes}")
    first_ptr = prev_ptr = None
    if first_flags is not None:
        if first_flags.shape != (h,) or first_flags.dtype != torch.bool:
            raise ValueError(f"first_flags must be ({h},) bool, got "
                             f"{tuple(first_flags.shape)} {first_flags.dtype}")
        first_flags = first_flags.contiguous().view(torch.uint8)
        first_ptr = first_flags.data_ptr()
    if init_prev is not None:
        if init_prev.shape != (w,) or init_prev.dtype != torch.float32:
            raise ValueError(f"init_prev must be ({w},) float32, got "
                             f"{tuple(init_prev.shape)} {init_prev.dtype}")
        init_prev = init_prev.contiguous()
        prev_ptr = init_prev.data_ptr()
    out = torch.empty((h, w), dtype=torch.float32, device=m0.device)
    launch("K1b", _row_scan, m0.device,
           m0.data_ptr(), a0.data_ptr(), c_zero.data_ptr(), diag_up.data_ptr(),
           diag_lf.data_ptr(), black.data_ptr(), first_ptr, prev_ptr, out.data_ptr(),
           h, w, float(smooth_factor), d_first, n_planes)
    return out
