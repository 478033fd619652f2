"""K4's own source, built for the host, against its plain twin.

K4 (``csrc/perceptual_scan.cuh``) walks each chunk strip by anti-diagonals:
warps hand their results to the next diagonal through a two-row ring in
shared memory closed by an mbarrier, and stage the volume ahead with
cp.async, which only the card runs. Here the same source is built with the
host's C++20 compiler, its block of PTX primitives swapped for the host
stand-ins of ``tests/k4_host/`` (one thread per CUDA thread, the CTAs one
after another, an mbarrier as one atomic word, a cp.async that lands only
when a wait lets it, shared memory filled with NaN bytes), and called
through ctypes on CPU tensors. It must equal ``perceptual/scan.py::
window_scan_plain`` bit for bit (tolerance: none) on ``perceptual_volume``'s
planted cases, the NaN / +0.0 / -0.0 ones included, and with 4, 2, 1 or no
staged rows: a fault of the diagonal hand-off's ordering or parity, or
of the ring's slots, shows here as a wrong pixel or a wait that times out.
Skips where no C++ compiler is found.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu_torch.kernels import launch
from stereo_reconstruction_tpu_torch.perceptual import scan

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import perceptual_volume  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "stereo_reconstruction_tpu_torch", "csrc")

# (h, d, w, chunk, kind): kind False, True (ties) or "specials" (NaN, +-0.0)
CASES = [
    (6, 12, 50, 20, False), (5, 12, 50, 20, True), (5, 12, 50, 20, "specials"),
    (4, 7, 1, 20, False), (5, 8, 33, 1, True), (3, 12, 20, 1, "specials"),
    (1, 12, 50, 20, False), (3, 12, 60, 20, True), (4, 33, 50, 20, False),
    (4, 12, 70, 33, True), (3, 40, 130, 64, "specials"), (4, 12, 21, 20, False),
    (2, 200, 230, 20, False),
    # staged rows: 2 (D=150, 200), 1 (D=300) at chunk 120-150; none (the
    # direct instance) at D=600, chunk 100
    (3, 150, 127, 120, True), (2, 200, 127, 120, False), (2, 300, 157, 150, "specials"),
    (2, 600, 107, 100, False),
]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler to build K4's source for the host")
    src = open(os.path.join(CSRC, "perceptual_scan.cuh")).read()
    a = src.index("// ---- PTX primitives")
    b = src.index("// ---- end of PTX primitives")
    with open(os.path.join(HERE, "k4_host", "primitives.inc")) as f:
        src = src[:a] + f.read() + src[b:]
    decl = "extern __shared__ __align__(16) unsigned char smem[];"
    assert src.count(decl) == 1
    src = src.replace(decl, "unsigned char* smem = reinterpret_cast<unsigned char*>("
                            "host::smem_of(blockIdx.x));")
    launcher = open(os.path.join(CSRC, "perceptual_scan.cu")).read()
    launches = launcher.count("<<<")
    launcher, n = re.subn(r"([\w:]+)<<<(.*?)>>>\((.*?)\);",
                          r"if (!host::launch_ctas(\2, [&] { \1(\3); }))"
                          r" return (int)cudaErrorLaunchFailure;", launcher, flags=re.S)
    assert n == launches >= 1 and "<<<" not in launcher
    out = tmp_path_factory.mktemp("k4_host")
    (out / "perceptual_scan.cuh").write_text(src)
    (out / "perceptual_scan.cu").write_text(launcher)
    so = out / "libk4_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-ffp-contract=off",
                    "-pthread", "-I", os.path.join(HERE, "k4_host"), "-x", "c++",
                    str(out / "perceptual_scan.cu"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    launch.declare(lib)
    return lib


def test_stage_counts_cover_every_instance(lib):
    """The cases stage 4, 2, 1 and 0 rows a position (the last is the
    direct instance): the shared memory past the barrier, the two rows of
    indices, the table and the ones, over one staged row of the strip."""
    counts = set()
    for _, d, w, chunk, _ in CASES:
        c = min(chunk, w)
        ring = -(-(-(-(16 + 8 * c) // 16) * 16 + 8 * (d + 1)) // 16) * 16
        stages, rest = divmod(lib.stpu_perceptual_scan_smem_bytes(d, c) - ring,
                              4 * -(-d // 4) * 4 * c)
        assert rest == 0
        counts.add(stages)
    assert counts == {0, 1, 2, 4}


@pytest.mark.parametrize("h,d,w,chunk,kind", CASES)
def test_k4_source_equals_twin_on_the_host(lib, h, d, w, chunk, kind):
    vol = torch.from_numpy(perceptual_volume(np.random.default_rng(w + chunk), h, d, w,
                                             ties=kind is True, specials=kind == "specials"))
    table = scan.weight_table(d, 25.0, 0.85)
    want = scan.window_scan_plain(vol, table, chunk)
    got = torch.full((h, w), 12345.0)
    cols = torch.full((lib.stpu_perceptual_scan_scratch_bytes(h, d, w) // 4,), float("nan"))
    rc = lib.stpu_perceptual_scan(vol.data_ptr(), table.data_ptr(), cols.data_ptr(),
                                  got.data_ptr(), h, d, w, chunk, None)
    assert rc == 0, f"host launch failed: {rc}"
    np.testing.assert_array_equal(got.numpy(), want.numpy())
