"""ctypes bindings for the native C++ IO runtime (``native/stereo_io.cpp``).

Port of ``stereo_reconstruction_tpu/io/native.py``: zlib PNG decode, the
PFM codec and a threaded batch PNG reader in ``native/libstereo_io.so``.
Only the library in ``native/`` at the root of the checkout is loaded,
never the copy the JAX package's installer puts inside that package.
Where the library is absent it is built once with ``native/Makefile``
(``g++`` and zlib); the build goes to ``build/native_io/`` and is moved
into ``native/`` whole. Where it cannot be built, ``available()`` is
false and ``io/image.py`` reads with PIL.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
NATIVE_DIR = ROOT / "native"
LIB_PATH = NATIVE_DIR / "libstereo_io.so"
BUILD_DIR = ROOT / "build" / "native_io"

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def build_library() -> Path:
    """Build ``native/libstereo_io.so`` with ``native/Makefile``; return its
    path. Raises ``RuntimeError`` with make's output when the build fails."""
    if LIB_PATH.is_file():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        tmp = work / LIB_PATH.name
        try:
            proc = subprocess.run(["make", "-C", str(NATIVE_DIR), f"TARGET={tmp}"],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise RuntimeError(f"make -C {NATIVE_DIR} could not run: {exc}") from exc
        if proc.returncode != 0 or not tmp.is_file():
            raise RuntimeError(f"make -C {NATIVE_DIR} failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return LIB_PATH


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library with its argument types declared, built on first
    use; None when it cannot be built (``build_error()`` says why)."""
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        path = build_library()
    except RuntimeError as exc:
        _build_error = str(exc)
        return None
    lib = ctypes.CDLL(str(path))
    i, p = ctypes.c_int, ctypes.POINTER
    info = [ctypes.c_char_p, p(i), p(i), p(i)]
    lib.stereo_io_png_info.argtypes = info
    lib.stereo_io_png_read.argtypes = [ctypes.c_char_p, p(ctypes.c_uint8), i, i, i]
    lib.stereo_io_pfm_info.argtypes = info
    lib.stereo_io_pfm_read.argtypes = [ctypes.c_char_p, p(ctypes.c_float), i, i, i]
    lib.stereo_io_pfm_write.argtypes = lib.stereo_io_pfm_read.argtypes
    lib.stereo_io_png_read_batch.argtypes = [ctypes.c_char_p, i, p(ctypes.c_uint8),
                                             i, i, i, i]
    for name in ("png_info", "png_read", "pfm_info", "pfm_read", "pfm_write",
                 "png_read_batch"):
        getattr(lib, f"stereo_io_{name}").restype = i
    lib.stereo_io_last_error.argtypes = []
    lib.stereo_io_last_error.restype = ctypes.c_char_p
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built, or None."""
    load_library()
    return _build_error


def _require() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native stereo_io library not available: {_build_error}")
    return lib


def _check(rc: int, lib) -> None:
    if rc != 0:
        raise IOError(lib.stereo_io_last_error().decode())


def read_png(path: str, channels: int = 3) -> np.ndarray:
    lib = _require()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib.stereo_io_png_info(path.encode(), w, h, c), lib)
    out = np.empty((h.value, w.value, channels), np.uint8)
    _check(lib.stereo_io_png_read(path.encode(),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                  h.value, w.value, channels), lib)
    return out[..., 0] if channels == 1 else out


def read_pfm(path: str) -> np.ndarray:
    lib = _require()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib.stereo_io_pfm_info(path.encode(), w, h, c), lib)
    shape = (h.value, w.value, c.value) if c.value == 3 else (h.value, w.value)
    out = np.empty(shape, np.float32)
    _check(lib.stereo_io_pfm_read(path.encode(),
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                  h.value, w.value, c.value), lib)
    return out


def write_pfm(path: str, image: np.ndarray) -> None:
    lib = _require()
    image = np.ascontiguousarray(image, np.float32)
    c = 1 if image.ndim == 2 else image.shape[2]
    _check(lib.stereo_io_pfm_write(path.encode(),
                                   image.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                   image.shape[0], image.shape[1], c), lib)


def read_png_batch(paths: List[str], height: int, width: int, channels: int = 3,
                   num_threads: int = 0) -> np.ndarray:
    """Threaded decode of PNGs of one shape into one (N, H, W, C) array."""
    lib = _require()
    joined = b"\0".join(p.encode() for p in paths) + b"\0\0"
    out = np.empty((len(paths), height, width, channels), np.uint8)
    _check(lib.stereo_io_png_read_batch(joined, len(paths),
                                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                        height, width, channels, num_threads), lib)
    return out
