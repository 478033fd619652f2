"""Build and load the hand-written Hopper kernels.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` for ``sm_90a``,
all of them at once, and the objects are linked into one shared library
with a plain C interface, which is loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library lands in
``build/stpu_torch_kernels/<source-hash>/`` at the root of the checkout
and is built on first use only. A missing ``nvcc`` or a failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "stpu_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIB = None
BUILD_INFO: dict = {}


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.isfile(candidate):
            nvcc = candidate
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Build the kernel library if needed; return its path."""
    cu = sorted(CSRC_DIR.glob("*.cu"))
    sources = cu + sorted(CSRC_DIR.glob("*.cuh"))
    out_dir = BUILD_ROOT / _source_hash(sources)
    lib = out_dir / "libstpu_torch_kernels.so"
    if lib.is_file():
        return lib
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))
    t0 = time.perf_counter()
    try:
        objs = [work / f"{src.stem}.o" for src in cu]
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                             for src, obj in zip(cu, objs))]
        log = ""
        failed = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = work / lib.name
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(log)
    BUILD_INFO.update(seconds=seconds, log=log)
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's argument and return types declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(library_path()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.stpu_matcher_inputs.argtypes = [p, p, p, p, p, p, p, p,
                                            i, i, i, i, i, i, i, i, i, p]
        lib.stpu_matcher_inputs.restype = i
        lib.stpu_matcher_inputs_max_hbs.argtypes = []
        lib.stpu_matcher_inputs_max_hbs.restype = i
        lib.stpu_row_scan_max_width.argtypes = []
        lib.stpu_row_scan_max_width.restype = i
        lib.stpu_cost_volume.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        lib.stpu_cost_volume.restype = i
        lib.stpu_block_search.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                                          i, i, ctypes.c_float, i, i, p]
        lib.stpu_block_search.restype = i
        lib.stpu_row_scan.argtypes = [p, p, p, p, p, p, p, p, p, i, i,
                                      ctypes.c_float, i, i, p]
        lib.stpu_row_scan.restype = i
        lib.stpu_row_scan_error.argtypes = [i]
        lib.stpu_row_scan_error.restype = ctypes.c_char_p
        lib.stpu_perceptual_scan.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.stpu_perceptual_scan.restype = i
        lib.stpu_perceptual_scan_smem_bytes.argtypes = [i, i]
        lib.stpu_perceptual_scan_smem_bytes.restype = ctypes.c_longlong
        lib.stpu_perceptual_scan_scratch_bytes.argtypes = [i, i, i]
        lib.stpu_perceptual_scan_scratch_bytes.restype = ctypes.c_longlong
        lib.stpu_perceptual_scan_max_smem.argtypes = []
        lib.stpu_perceptual_scan_max_smem.restype = ctypes.c_longlong
        lib.stpu_warp.argtypes = [p, p, p, i, i, i, p, i, i, i, p]
        lib.stpu_warp.restype = i
        lib.stpu_warp_max_images.argtypes = []
        lib.stpu_warp_max_images.restype = i
        lib.stpu_warp_error.argtypes = [i]
        lib.stpu_warp_error.restype = ctypes.c_char_p
        lib.stpu_ransac.argtypes = [p, p, ctypes.c_float, ctypes.c_float, p]
        lib.stpu_ransac.restype = i
        for name in ("stpu_ransac_max_points", "stpu_ransac_shared_keys",
                     "stpu_ransac_hyp_floats", "stpu_ransac_hyp_ints"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.stpu_ransac_error.argtypes = [i]
        lib.stpu_ransac_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
