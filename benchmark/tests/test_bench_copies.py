"""The benchmark's copies of the project's pieces equal their originals,
so a later change to the program cannot move the yardstick unseen: the
vectorised scene generator (``chip_smoke.nonplanar_scene``), the
roofline counts (``utils/roofline.py`` at PERF.md's kernel-table shapes),
the Loop-Zhang homographies and the seeded VGG-16 weights; and the
VGG-16 + Gram operation count, against a count made by convolution."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from benchmark import harness, roofline, scenes
from benchmark.reference import lpips, loop_zhang

sys.path.insert(0, str(harness.ROOT))

import chip_smoke  # noqa: E402
from stereo_reconstruction_tpu_torch.perceptual import vgg  # noqa: E402
from stereo_reconstruction_tpu_torch.rectify import loop_zhang as port_lz  # noqa: E402
from stereo_reconstruction_tpu_torch.utils import roofline as port_roofline  # noqa: E402


@pytest.mark.parametrize("h,w,seed", [(60, 80, 0), (90, 120, 7), (48, 64, 2**40 + 3)])
def test_scene_generator_equals_the_smoke_loop(h, w, seed):
    want = chip_smoke.nonplanar_scene(np.random.default_rng(seed), h, w)
    got = scenes.nonplanar_scene(np.random.default_rng(seed), h, w)
    for a, b in zip(want[:6], got):
        np.testing.assert_array_equal(a, b)


def test_rectified_pair_shows_the_true_disparity():
    h, w, D = 40, 96, 20
    left, right = scenes.rectified_pair(np.random.default_rng(5), h, w, D)
    d = scenes.rectified_disparity(h, w, D).numpy()
    assert left.shape == right.shape == (h, w, 3) and left.dtype == np.uint8
    assert 0.04 * D < d.min() and d.max() < 0.96 * D
    y, x = 20, 30
    xl = x + d[y, x]
    assert abs(float(right[y, x, 0]) - float(left[y, int(round(xl)), 0])) < 60


SHAPES = [dict(h=375, w=450, wl_extra=0, bs=17, min_d=0, max_d=100),
          dict(h=1128, w=1408, wl_extra=0, bs=17, min_d=0, max_d=200),
          dict(h=21, w=40, wl_extra=9, bs=5, min_d=2, max_d=51),
          dict(h=101, w=200, wl_extra=0, bs=9, min_d=1, max_d=31)]


@pytest.mark.parametrize("s", SHAPES)
def test_roofline_counts_equal_the_port(s):
    assert roofline.matcher_bytes_ops(s, 5) == port_roofline.matcher_bytes_ops(s, 5)
    assert roofline.scan_bytes_ops(s["h"], s["w"]) == port_roofline.scan_bytes_ops(s["h"], s["w"])
    b = roofline.matcher_bytes_ops(s, 5)
    assert roofline.bound(*b) == port_roofline.bound(*b)


def test_ssd_bounds_at_the_canvas():
    c = harness.cell(harness.load_spec(), "ssd_pair_fixedF")
    assert roofline.ssd_shape(c.config)["h"] == 1128 and roofline.ssd_shape(c.config)["w"] == 1408
    r = port_roofline.matcher_roofline(1128, 1408, 200)
    assert roofline.k1_bound_ms(c.config) == pytest.approx(r["kernels_ms"]["K1"])
    assert roofline.k1b_bound_ms(c.config) == pytest.approx(r["kernels_ms"]["K1b"])
    assert roofline.k1_bound_ms(c.config) == pytest.approx(0.1927, abs=1e-4)


def test_vgg_flops_equal_a_count_by_convolution():
    """Each 3x3 SAME convolution's products counted by convolving a map
    of ones with a kernel of ones (a tap that lands in the padding adds
    nothing), stage sides by the tower's own pools."""
    x = torch.zeros(1, 3, 17, 17)
    flops, side, c_in = 0.0, 17, 3
    for bi, (c_out, n) in enumerate(roofline.VGG16_BLOCKS):
        taps = torch.nn.functional.conv2d(torch.ones(1, 1, side, side), torch.ones(1, 1, 3, 3),
                                          padding=1).sum().item()
        for _ in range(n):
            flops += 2 * taps * c_in * c_out
            c_in = c_out
        if bi < 4:
            side = torch.nn.functional.max_pool2d(torch.ones(1, 1, side, side), 2).shape[-1]
    got, stages = roofline.vgg_crop_flops(17)
    assert got == flops
    blocks = [[(torch.zeros(c, ci, 3, 3), torch.zeros(c)) for c, ci in zip(
        [c] * n, [prev] + [c] * (n - 1))] for (c, n), prev in zip(
        roofline.VGG16_BLOCKS, (3, 64, 128, 256, 512))]
    outs = lpips.tower(x, blocks)
    assert stages == [(o.shape[1], o.shape[2]) for o in outs]
    features = sum(c * s * s for c, s in stages)
    assert roofline.vgg_search_flops(375, 450, 100, 17) == (
        2 * 375 * 450 * got + 2.0 * 375 * sum(min(100, 450 - x) for x in range(450)) * features)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_loop_zhang_equals_the_port(seed):
    rng = np.random.default_rng(seed)
    K, R, T = scenes.camera_pair(750, 900)
    R = R @ scenes.rodrigues(rng.normal(0, 0.02, 3))
    F = scenes.true_fundamental(K, R, T + rng.normal(0, 0.05, 3))
    got = loop_zhang.loop_zhang_homographies(F, (750, 900), (750, 900))
    want = port_lz.loop_zhang_homographies(F, (750, 900), (750, 900))
    np.testing.assert_array_equal(got[0], want.H_left)
    np.testing.assert_array_equal(got[1], want.H_right)


def test_vgg_weights_equal_the_port():
    got = lpips.vgg16_weights(12345)
    want = vgg.init_vgg16_params(12345)["convs"]
    for gb, wb in zip(got, want):
        for (gw, gbias), (ww, wbias) in zip(gb, wb):
            np.testing.assert_array_equal(gw, ww)
            np.testing.assert_array_equal(gbias, wbias)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0000002, float("inf")])
    got = lpips.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0, float("inf")]
