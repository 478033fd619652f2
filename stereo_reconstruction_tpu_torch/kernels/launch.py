"""The one seam between the port's PyTorch code and its CUDA library.

A launcher (``ops/cuda_*.py``, ``perceptual/scan.py``) declares each C
entry point it calls with ``entry`` at import time, picks its route with
``on_card`` and launches with ``launch``, which passes the stream, raises
on a CUDA error with its name and counts the launch in ``LAUNCHES``.
``build.load_library`` declares every registered entry point when it
loads the library; ``declare`` does the same for any other ``ctypes``
library built from the same sources (the host builds of the tests).
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Callable, Dict, List, Tuple

import torch

from stereo_reconstruction_tpu_torch.kernels import build

# kernel launches by kernel: "K1", "K2", "K3", "K1b", "K4", "warp", "ransac";
# the plain twins never count
LAUNCHES: Counter = Counter()

# every entry point's (argtypes, restype), by its C name
SIGNATURES: Dict[str, Tuple[List, object]] = {}


def declare(lib) -> None:
    """Give each registered entry point that ``lib`` exports its argument
    and return types."""
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, restype


def entry(name: str, argtypes: List, restype) -> Callable:
    """Register the C entry point ``name``; return a callable that calls it
    in the kernel library, which it builds and loads on its first call."""
    if name in SIGNATURES:
        raise ValueError(f"{name} is declared twice")
    SIGNATURES[name] = (argtypes, restype)
    if build._LIB is not None:        # a launcher imported after the library was loaded
        declare(build._LIB)

    def call(*args):
        return getattr(build.load_library(), name)(*args)

    return call


def on_card(kernel: str, *tensors) -> bool:
    """False when every tensor given (``None`` skipped) is on the CPU, so
    the plain twin runs; True when they all sit on one CUDA device, so the
    kernel runs. Anything else raises ``ValueError`` before the library is
    loaded."""
    devices = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return True
    raise ValueError(f"{kernel} needs all its tensors on the CPU or on one CUDA device, got "
                     f"{sorted(map(str, devices))}")


_error_name = entry("stpu_error_name", [ctypes.c_int], ctypes.c_char_p)


def launch(kernel: str, fn: Callable, device: torch.device, *args, count: int = 1) -> None:
    """``fn(*args, stream)`` on the current stream of CUDA ``device``; a
    non-zero return raises ``RuntimeError`` naming the kernel and the CUDA
    error, else ``count`` launches are added to ``LAUNCHES[kernel]``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc} "
                           f"({_error_name(rc).decode()})")
    LAUNCHES[kernel] += count
