"""K4, the windowed smoother of the perceptual matcher
(``csrc/perceptual_scan.cuh``), its plain twin, and the wrapper that picks
between them by device.

K4 replaces the ``lax.scan`` + ``lax.while_loop`` of
``stereo_reconstruction_tpu/perceptual/cost.py::windowed_smooth_argmin``:
the reference notebook's chunked multiplicative smoothing (cell 10) of an
(H, D, W) cost volume into (H, W) argmin indices. JAX resolves a row's
in-chunk recurrence by Jacobi sweeps to their fixpoint; the port resolves
each chunk's pixels left to right, which is that fixpoint.

Both take the weights as a table, ``weight_table``: every argument of the
notebook's weight is an integer in [0, D], so the kernel and the twin
multiply by the same float32 numbers and agree bit for bit, and a test can
hand them the JAX package's own weights.

The wrapper takes the twin only for CPU tensors. CUDA tensors launch the
kernel or raise; nothing falls back. On the card K4 takes a scratch copy of
the volume in (H, W, D) order, as large as the volume.
"""

from __future__ import annotations

import torch

# kernel launches made by ``window_scan``; the plain twin never counts
LAUNCHES = 0


def weight_table(n: int, sigma: float, bias: float, device="cpu") -> torch.Tensor:
    """(n + 1,) float32 ``table[k] = (1 - exp(-k / sigma)) + bias``, the
    notebook's ``weight_vector`` (cell 8) at integer distance k, in the JAX
    package's float32 steps with a correctly rounded exp. Built on the host,
    so every device gets the same numbers."""
    k = torch.arange(n + 1, dtype=torch.float32)
    e = torch.exp((-k / sigma).double()).float()
    return ((1.0 - e) + bias).to(device)


def window_scan_plain(cost: torch.Tensor, table: torch.Tensor, chunk: int) -> torch.Tensor:
    """The plain twin of K4: (H, D, W) costs -> (H, W) float32 argmin
    indices. Row y > 0 weights candidate d by ``table[|d - disp[y-1, x]|]``;
    a pixel that is not the first of its chunk then weights it by
    ``table[|d - min(disp[y, x-1], min(D, W - x))|]``. Position p of every
    chunk resolves at once, p = 0 .. chunk-1 in order."""
    h, D, w = cost.shape
    dev = cost.device
    d = torch.arange(D, device=dev)[:, None]
    sizes = torch.clamp(w - torch.arange(w, device=dev), max=D)
    out = torch.empty((h, w), dtype=torch.long, device=dev)
    for y in range(h):
        cu = cost[y]
        if y > 0:
            cu = cu * table[(d - out[y - 1]).abs()]
        left = None
        for p in range(min(chunk, w)):
            c = cu[:, p::chunk]
            if p > 0:
                mean = torch.minimum(left[:c.shape[1]], sizes[p::chunk])
                c = c * table[(d - mean).abs()]
            left = torch.argmin(c, dim=0)
            out[y, p::chunk] = left
    return out.to(torch.float32)


def max_smem() -> int:
    """The most dynamic shared memory K4 may take (bytes), as the kernel
    library defines it; builds the library on first use."""
    from stereo_reconstruction_tpu_torch.kernels.build import load_library

    return load_library().stpu_perceptual_scan_max_smem()


def window_scan(cost: torch.Tensor, table: torch.Tensor, chunk: int) -> torch.Tensor:
    """(H, W) float32 argmin indices of the windowed smoother: the plain
    twin for CPU tensors, K4 for CUDA tensors."""
    global LAUNCHES
    if cost.device.type == "cpu" and table.device.type == "cpu":
        return window_scan_plain(cost, table, chunk)
    device = cost.device
    if device.type != "cuda" or table.device != device:
        raise ValueError(f"K4 needs the volume and the table on one CUDA device, got "
                         f"{cost.device} and {table.device}")
    if cost.ndim != 3 or cost.dtype != torch.float32 or not cost.is_contiguous():
        raise ValueError(f"K4 takes a contiguous (H, D, W) float32 volume, got "
                         f"{tuple(cost.shape)} {cost.dtype}")
    h, D, w = cost.shape
    if h < 1 or w < 1 or D < 1:
        raise ValueError(f"K4 needs H, D and W >= 1, got H={h}, D={D}, W={w}")
    if table.shape != (D + 1,) or table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError(f"K4 needs a contiguous float32 table of D + 1 = {D + 1} weights, "
                         f"got {tuple(table.shape)} {table.dtype}")
    if chunk < 1:
        raise ValueError(f"K4 needs chunk >= 1, got {chunk}")
    for name, v in (("H", h), ("D", D), ("W", w)):
        if v >= 2**31:
            raise ValueError(f"K4 takes {name} < 2^31, got {v}")
    chunk = min(chunk, w)                 # one chunk a row is the same recurrence
    from stereo_reconstruction_tpu_torch.kernels.build import load_library

    lib = load_library()
    smem = lib.stpu_perceptual_scan_smem_bytes(D, chunk)
    if smem > max_smem():
        raise ValueError(f"K4's shared memory for D={D} and chunk={chunk} is {smem} bytes, "
                         f"above the {max_smem()} a CTA may have (the D + 1 weights, D + 1 "
                         f"ones and two rows of chunk indices)")
    # the volume's (H, W, D) copy that K4's scan reads
    cols = torch.empty(lib.stpu_perceptual_scan_scratch_bytes(h, D, w) // 4,
                       dtype=torch.float32, device=device)
    out = torch.empty((h, w), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = lib.stpu_perceptual_scan(cost.data_ptr(), table.data_ptr(), cols.data_ptr(),
                                      out.data_ptr(), h, D, w, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
