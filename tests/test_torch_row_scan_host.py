"""K1b's own source, built for the host, against its plain twin.

K1b (``csrc/row_scan.cuh``) hands the case leaving each 64-column strip to
the strip on its right through mbarriers and distributed shared memory,
which only the card runs. Here the same source is built with the host's
C++20 compiler, its block of PTX primitives swapped for the host stand-ins
of ``tests/k1b_host/`` (one thread per CUDA thread, every CTA of the
cluster at once, an mbarrier as one atomic word), and called through
ctypes on CPU tensors. It must equal ``ops/smoothing.py::
smoothed_argmin_from_inputs`` bit for bit (tolerance: none), plain and
seeded, on ``scan_volume``'s and ``chain_planes``' planes at widths that
cross strips inside a CTA and across CTAs: a fault of the hand-off's
ordering, its slot ring or its parities shows here as a wrong pixel or a
wait that times out. Skips where no C++ compiler is found.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu_torch.ops import smoothing as tsm

from torch_helpers import chain_planes, scan_volume, seed_rows

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "stereo_reconstruction_tpu_torch", "csrc")
D = 12
# one strip, one to eight CTAs of one strip, then 2 and 3 strips a CTA
WIDTHS = (1, 31, 33, 64, 65, 129, 511, 513, 1100)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler to build K1b's source for the host")
    src = open(os.path.join(CSRC, "row_scan.cuh")).read()
    a = src.index("// ---- PTX primitives")
    b = src.index("// ---- end of PTX primitives")
    with open(os.path.join(HERE, "k1b_host", "primitives.inc")) as f:
        src = src[:a] + f.read() + src[b:]
    assert src.count("__shared__ Rings rings;") == 1
    src = src.replace("__shared__ Rings rings;",
                      "Rings& rings = *reinterpret_cast<Rings*>(host::smem_of(blockIdx.x));")
    out = tmp_path_factory.mktemp("k1b_host")
    with open(out / "row_scan.cuh", "w") as f:
        f.write(src)
    shutil.copy(os.path.join(CSRC, "row_scan.cu"), out / "row_scan.cu")
    so = out / "libk1b_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-ffp-contract=off",
                    "-pthread", "-I", os.path.join(HERE, "k1b_host"), "-x", "c++",
                    str(out / "row_scan.cu"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.stpu_row_scan.argtypes = [p] * 9 + [i, i, ctypes.c_float, i, i, p]
    lib.stpu_row_scan.restype = i
    return lib


def _host_scan(lib, planes, black, sf, d_first, first=None, init=None):
    h, w = black.shape
    out = torch.full((h, w), 12345.0)
    black = black.to(torch.uint8).contiguous()
    first = None if first is None else first.to(torch.uint8).contiguous()
    rc = lib.stpu_row_scan(*(t.contiguous().data_ptr() for t in planes), black.data_ptr(),
                           None if first is None else first.data_ptr(),
                           None if init is None else init.data_ptr(), out.data_ptr(),
                           h, w, sf, d_first, D, None)
    assert rc == 0, f"host launch failed: {rc}"
    return out


@pytest.mark.parametrize("seeded", [False, True])
@pytest.mark.parametrize("kind", ["scan_volume", "chain_planes"])
@pytest.mark.parametrize("w", WIDTHS)
def test_k1b_source_equals_twin_on_the_host(lib, w, kind, seeded):
    rng = np.random.default_rng(w + 7 * seeded + 100 * (kind == "chain_planes"))
    h = 1 if w == 31 else 2 if w == 33 else 12
    ties = bool(w % 2)
    sf, d_first = (1.0 if ties else 0.9), w % 3
    if kind == "scan_volume":
        cost, black = scan_volume(rng, h, w, D, ties)
        planes = tsm.volume_reductions(torch.from_numpy(cost), d_first)
    else:
        *planes, black = (torch.from_numpy(a) for a in chain_planes(rng, h, w, D, ties))
    black = torch.as_tensor(black)
    first = init = None
    if seeded:
        first, init = (torch.from_numpy(a) for a in seed_rows(rng, h, w, D))
    want = tsm.smoothed_argmin_from_inputs(*planes, black, smooth_factor=sf, d_first=d_first,
                                           n_planes=D, first_flags=first, init_prev=init)
    got = _host_scan(lib, planes, black, sf, d_first, first, init)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
