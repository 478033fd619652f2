"""The SIFT scale-space kernels' own source, built for the host, against their
plain twin.

``csrc/sift.cuh`` (launched by ``ops/cuda_sift.py``) runs a CTA a tile, its
threads meeting at ``__syncthreads``. Here the same source is built with the
host's C++ compiler against the stand-ins of ``tests/sift_host/`` (a CTA's
threads as fibers, dynamic shared memory filled with NaN at each CTA;
``-ffp-contract=off``) and called through ctypes on CPU tensors, through the
launcher's own argument marshalling and ``ops/features.py``'s kernel route
(``scale_space_kernel``), with ``kernels/launch.py::launch`` replaced by a
host call.

The twin is ``ops/features.py::scale_space_plain`` with
``blur_in_tap_order``, the card's eager path, on CPU tensors. The Gaussian
levels, DoG planes, responses and gradient magnitudes must equal it bit for
bit. The angles are ``atan2f`` in the kernel (glibc's here, CUDA's on the
card) and ``torch.atan2`` in the twin (SLEEF's ``atan2f`` u10 on the CPU's
vector path, glibc's on its tail): each is within 1 ulp of the exact angle,
so they may differ by 2 ulp, and no more. The card test
(``tests/test_torch_cuda.py``) holds the card's angles to the card twin's bit
for bit.

Cases: every radius that SIFT, ORB and BRISK ask for at their defaults;
planes barely larger than the radius, where one tile reflects on both
sides; a stride-2 source copied through; the whole scale space of a
textured pair, four octaves (25 launches); an image alone equal to itself
inside a batch of 16; and the launcher's ``ValueError`` for a radius, a
plane or a scale count it cannot hold, raised before the library loads.
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

from stereo_reconstruction_tpu_torch.config import BriskConfig, FrontendConfig
from stereo_reconstruction_tpu_torch.kernels import build, launch
from stereo_reconstruction_tpu_torch.ops import cuda_sift
from stereo_reconstruction_tpu_torch.ops import features as tf
from stereo_reconstruction_tpu_torch.ops.binary_features import _brisk_pattern

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "..", "stereo_reconstruction_tpu_torch", "csrc")
sys.path.insert(0, os.path.join(HERE, ".."))
from chip_smoke import nonplanar_scene  # noqa: E402

torch.set_num_threads(1)

CONFIG = FrontendConfig()
# SIFT's init sigma and level steps; ORB's Harris and BRIEF blurs; BRISK's rings
SIGMAS = ([CONFIG.init_sigma, *tf._level_sigmas(CONFIG)[1], 1.5, 2.0]
          + [float(s) for s in _brisk_pattern(BriskConfig().pattern_scale,
                                              BriskConfig().max_bits)[2]])
RADII = sorted({(len(tf._taps(s)) - 1) // 2 for s in SIGMAS})
ANGLE_ULPS = 2   # glibc's atan2f and SLEEF's u10, each within 1 ulp of the exact angle


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the SIFT kernels' source for the host")
    launcher = open(os.path.join(CSRC, "sift.cu")).read()
    launches = launcher.count("<<<")
    launcher, n = re.subn(r"([\w:]+)<<<(.*?), (.*?), (.*?), .*?>>>\((.*?)\);",
                          r"host::launch_smem(\2, \3, \4, [&] { \1(\5); });", launcher,
                          flags=re.S)
    assert n == launches == 2 and "<<<" not in launcher
    header = open(os.path.join(CSRC, "sift.cuh")).read()
    header, n = re.subn(r"extern __shared__ float smem\[\];",
                        "float* const smem = host::dynamic_smem();", header)
    assert n == 2
    out = tmp_path_factory.mktemp("sift_host")
    (out / "sift.cuh").write_text(header)
    (out / "sift.cu").write_text(launcher)
    so = out / "libsift_host.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-ffp-contract=off",
                    "-pthread", "-I", os.path.join(HERE, "sift_host"), "-x", "c++",
                    str(out / "sift.cu"), "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    launch.declare(lib)
    calls = []

    def host_launch(kernel, fn, device, *args, count=1):
        assert kernel == "sift" and device.type == "cpu"
        rc = fn(*args, None)
        assert rc == 0, f"host launch refused: {rc}"
        calls.append(count)

    # the launcher's entry points call the host build, and its launches run
    # on the host, for this module's tests
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "load_library", lambda: lib)
        mp.setattr(cuda_sift, "launch", host_launch)
        yield calls


def _images(b, h, w, seed=0):
    """B textured grey images of the posed scene, 0..1 as SIFT sees them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(-(-b // 2)):
        left, right = nonplanar_scene(rng, h, w)[:2]
        out += [left, right]
    return tf._gray(torch.from_numpy(np.stack(out[:b])))


def _layered(gray, seed=0):
    """``gray`` half and half with a bicubic 5x6 random field, so that the
    coarsest octave of a 200x240 image (25x30, a 9x14 interior) has
    extrema too."""
    coarse = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (gray.shape[0], 1, 5, 6)).astype(np.float32))
    up = torch.nn.functional.interpolate(coarse, size=gray.shape[-2:], mode="bicubic",
                                         align_corners=False)[:, 0]
    return (gray * 0.5 + up * 0.5).contiguous()


def _ulps(a, b):
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(2 ** 31) - ia, ia)
    ib = torch.where(ib < 0, -(2 ** 31) - ib, ib)
    return (ia - ib).abs()


@pytest.mark.parametrize("radius", RADII)
def test_level_equals_blur_in_tap_order_at_every_radius(host, radius):
    sigma = next(s for s in SIGMAS if (len(tf._taps(s)) - 1) // 2 == radius)
    src = _images(3, 45, 70)
    dst = torch.empty_like(src)
    cuda_sift.level(src, tf._taps(sigma).tolist(), dst)
    assert torch.equal(dst, tf.blur_in_tap_order(src, sigma))


@pytest.mark.parametrize("radius", [RADII[0], 5, 9])
@pytest.mark.parametrize("extra", [(1, 1), (1, 4), (3, 1), (33, 2)])
def test_level_on_planes_barely_larger_than_the_radius(host, radius, extra):
    """Sides from radius + 1 up: one tile reflects at both of its ends."""
    sigma = next(s for s in SIGMAS if (len(tf._taps(s)) - 1) // 2 == radius)
    h, w = radius + extra[0], radius + extra[1]
    src = torch.from_numpy(np.random.default_rng(radius).uniform(0, 1, (2, h, w))
                           .astype(np.float32))
    dst = torch.empty_like(src)
    cuda_sift.level(src, tf._taps(sigma).tolist(), dst)
    assert torch.equal(dst, tf.blur_in_tap_order(src, sigma))


def test_level_reads_a_stride_2_plane_and_copies_it(host):
    """The next octave's first level: level s of a stack at stride 2, copied
    into plane 0 of the new stack and blurred into plane 1."""
    stack = _images(4, 61, 75).reshape(2, 2, 61, 75)
    src = stack[:, 1, ::2, ::2]
    new = torch.full((2, 6, 31, 38), float("nan"))
    sigma = tf._level_sigmas(CONFIG)[1][0]
    cuda_sift.level(src, tf._taps(sigma).tolist(), new[:, 1], copy=new[:, 0])
    assert torch.equal(new[:, 0], src)
    assert torch.equal(new[:, 1], tf.blur_in_tap_order(src, sigma))
    assert bool(new[:, 2:].isnan().all())


def _compare(got: tf.ScaleSpace, want: tf.ScaleSpace):
    for field in ("gauss", "dog", "response"):
        for o, (g, w) in enumerate(zip(getattr(got, field), getattr(want, field))):
            assert torch.equal(g, w), (field, o)
    assert torch.equal(got.mag, want.mag)
    assert int(_ulps(got.ang, want.ang).max()) <= ANGLE_ULPS
    assert torch.equal(got.ang == 0, want.ang == 0)


def test_scale_space_equals_the_twin_in_25_launches(host):
    """Four octaves of a textured pair: every plane equal to the twin's, in
    1 + 4 x 5 level launches and 4 detection launches, with keypoints found
    in every octave; their positions, scales and responses equal."""
    gray = _layered(_images(2, 200, 240))
    host.clear()
    got = tf.scale_space_kernel(gray, CONFIG)
    assert len(host) == 25 and len(got.dog) == 4
    want = tf.scale_space_plain(gray, CONFIG)
    _compare(got, want)
    for response in got.response:
        assert int((response > 0).sum()) > 0
    kg, kw = tf._detect(gray, CONFIG, got), tf._detect(gray, CONFIG, want)
    for key in ("xy", "scale", "response", "valid", "plane", "yi", "xi", "oh", "ow"):
        assert torch.equal(kg[key], kw[key]), key


def test_an_image_alone_equals_itself_in_a_batch_of_16(host):
    gray = _images(16, 40, 52, seed=3)
    batch = tf.scale_space_kernel(gray, CONFIG)
    alone = tf.scale_space_kernel(gray[5:6].clone(), CONFIG)
    for field in ("gauss", "dog", "response"):
        for b, a in zip(getattr(batch, field), getattr(alone, field)):
            assert torch.equal(b[5:6], a), field
    assert torch.equal(batch.mag[5:6], alone.mag) and torch.equal(batch.ang[5:6], alone.ang)
    _compare(batch, tf.scale_space_plain(gray, CONFIG))


@pytest.mark.parametrize("first,h0,w0,levels", [(0, 40, 56, None), (3, 51, 70, None),
                                                (0, 40, 56, 16)])
def test_detection_equals_the_twin_on_random_stacks(host, first, h0, w0, levels):
    """Random Gaussian stacks, so that extrema and edge tests are dense
    (uniform noise: ~1 pixel in 14 an extremum), or with ``levels`` values,
    so that neighbours tie; written into the (oh, ow) corner of slots
    ``first``.. of gradient stacks larger than the octave, nothing around
    it."""
    B, s, oh, ow = 3, CONFIG.scales_per_octave, 40, 56
    u = np.random.default_rng(first).uniform(0, 1, (B, s + 3, oh, ow))
    if levels is not None:
        u = np.floor(u * levels) / levels
    G = torch.from_numpy(u.astype(np.float32))
    dog, response = torch.empty(B, s, oh, ow), torch.empty(B, s, oh, ow)
    mag = torch.full((B, first + s, h0, w0), float("nan"))
    ang = mag.clone()
    cuda_sift.detect(G, dog, response, mag, ang, first, CONFIG.contrast_threshold / s,
                     CONFIG.edge_threshold)
    center, want_response, want_mag, want_ang = tf._octave_planes(G, G[:, 1:] - G[:, :-1],
                                                                  CONFIG)
    assert torch.equal(dog, center) and torch.equal(response, want_response)
    assert int((response > 0).sum()) > 100
    slots = slice(first, first + s)
    assert torch.equal(mag[:, slots, :oh, :ow], want_mag)
    assert int(_ulps(ang[:, slots, :oh, :ow], want_ang).max()) <= ANGLE_ULPS
    for t in (mag, ang):
        written = torch.zeros_like(t, dtype=torch.bool)
        written[:, slots, :oh, :ow] = True
        assert bool(t[~written].isnan().all())


def test_the_cpu_route_is_the_matmul_path(host):
    """A CPU tensor takes the matmul blur's scale space and no launch."""
    gray = _images(2, 40, 52)
    host.clear()
    got = tf.scale_space(gray, CONFIG)
    assert not host
    want = tf.scale_space_plain(gray, CONFIG, tf.gaussian_blur)
    for field in got._fields:
        for g, w in zip(*(x if isinstance(x, list) else [x] for x in
                          (getattr(got, field), getattr(want, field)))):
            assert torch.equal(g, w), field


def _no_library():
    raise AssertionError("the kernel library was loaded")


def test_limits_raise_before_the_library(host, monkeypatch):
    monkeypatch.setattr(build, "load_library", _no_library)
    host.clear()
    img = torch.zeros(2, 40, 40)
    wide = [0.0] * (2 * (cuda_sift.MAX_RADIUS + 1) + 1)
    with pytest.raises(ValueError, match="radii 1 to 24, got 25"):
        cuda_sift.level(img, wide, torch.empty_like(img))
    with pytest.raises(ValueError, match="wider and taller than the radius 9"):
        small = torch.zeros(1, 9, 30)
        cuda_sift.level(small, tf._taps(3.09).tolist(), torch.empty_like(small))
    with pytest.raises(ValueError, match="float32"):
        cuda_sift.level(img.double(), tf._taps(1.6).tolist(), torch.empty_like(img))
    stack = torch.zeros(1, 11, 20, 20)
    planes = torch.zeros(1, 8, 20, 20)
    with pytest.raises(ValueError, match="1 to 7 scales an octave, got 8"):
        cuda_sift.detect(stack, planes, planes, torch.zeros(1, 8, 20, 20),
                         torch.zeros(1, 8, 20, 20), 0, 0.01, 5.0)
    with pytest.raises(ValueError, match="needs all its tensors on the CPU or on one CUDA"):
        tf.gaussian_blur(torch.zeros(20, 20, device="meta"), 1.6)
    assert not host


def test_the_c_entry_points_refuse_what_the_kernel_cannot_hold(host):
    """The C launcher's own checks: the radius past kMaxRadius, a side not
    above the radius, more scales than kMaxScales."""
    img = torch.zeros(1, 60, 60)
    out = torch.empty_like(img)
    ok = [0.0] * (2 * cuda_sift.MAX_RADIUS + 1)
    assert cuda_sift.call_level(img, ok, out, None, None) == 0
    assert cuda_sift.call_level(img, ok + [0.0, 0.0], out, None, None) != 0
    small = torch.zeros(1, 24, 60)
    assert cuda_sift.call_level(small, ok, torch.empty_like(small), None, None) != 0
    for s, want_ok in ((cuda_sift.MAX_SCALES, True), (cuda_sift.MAX_SCALES + 1, False)):
        g = torch.zeros(1, s + 3, 20, 20)
        planes = torch.zeros(1, s, 20, 20)
        rc = cuda_sift.call_detect(g, planes, planes.clone(), planes.clone(), planes.clone(),
                                   0, (0.01, 5.0, 36.0), None)
        assert (rc == 0) == want_ok, s
