"""The warp's routing on the CPU (``ops/warp.py::warp_perspective`` and
``warp_inverse_maps``, which hand CUDA images to ``ops/cuda_warp.py``).

The kernel itself runs only on the card (``tests/test_torch_cuda.py``
holds it to its twin bit for bit). Here: CPU images, one or a batch, go to
the plain twin ``ops/warp.py::warp_inverse_map`` and count no launch,
whatever their dtype, layout or channels; a batch whose images differ in
channels raises;
``host_inverse``, the one place an inverse map is made, is the plain
path's ``torch.linalg.inv(H.float())`` bit for bit, alone and batched; a
singular H raises; images on a device that is neither the CPU nor a card
raise before any launch; and ``rectify_pair``, ``disparity_to_original_frame``
and ``run_batch`` on the CPU give exactly what their earlier forms gave
(a ``warp_perspective`` a side on a float32 tensor H, and ``vmap``s of it).
"""

import os
import sys

import numpy as np
import pytest
import torch
from torch.func import vmap

from stereo_reconstruction_tpu_torch import pipeline_batch as tpb
from stereo_reconstruction_tpu_torch.config import MatcherConfig, PipelineConfig
from stereo_reconstruction_tpu_torch.data.records import StereoPair
from stereo_reconstruction_tpu_torch.kernels.launch import LAUNCHES
from stereo_reconstruction_tpu_torch.ops import warp as twarp
from stereo_reconstruction_tpu_torch.rectify import rectifier as trect

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import flat_pair, nonplanar_scene  # noqa: E402
from torch_helpers import WARP_IMAGE_CASES, warp_images  # noqa: E402

torch.set_num_threads(1)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _homographies(rng, n):
    return np.stack([np.eye(3) + rng.normal(0, [[0.05, 0.05, 4], [0.05, 0.05, 4],
                                                 [5e-4, 5e-4, 0.02]]) for _ in range(n)])


def _old_warp(image, H, out_shape, method="bilinear"):
    """``warp_perspective`` as it was: the inverse of a tensor H on its device."""
    return twarp.warp_inverse_map(image, torch.linalg.inv(H.to(torch.float32)), out_shape,
                                  method)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("channels,dtype", [(None, np.uint8), (3, np.uint8), (1, np.float32),
                                            (3, np.float32)])
def test_wrapper_takes_the_plain_twin_for_cpu_images(rng, method, channels, dtype):
    shapes = [(30, 40), (25, 33), (30, 40)]
    imgs = []
    for h, w in shapes:
        shape = (h, w) if channels is None else (h, w, channels)
        a = (rng.integers(0, 256, shape) if dtype == np.uint8
             else rng.uniform(-20, 20, shape)).astype(dtype)
        imgs.append(torch.from_numpy(a))
    H = _homographies(rng, 3)
    before = LAUNCHES["warp"]
    got = twarp.warp_perspective(imgs, H, (36, 44), method)
    hinv = torch.linalg.inv(torch.from_numpy(H).float())
    want = torch.stack([twarp.warp_inverse_map(img, m, (36, 44), method)
                        for img, m in zip(imgs, hinv)])
    assert LAUNCHES["warp"] == before
    assert got.shape == want.shape == (3, 36, 44, *(() if channels is None else (channels,)))
    assert torch.equal(_bits(got), _bits(want))
    for img, h, g in zip(imgs, H, got):
        assert torch.equal(_bits(twarp.warp_perspective(img, h, (36, 44), method)), _bits(g))
        assert torch.equal(_bits(_old_warp(img, torch.from_numpy(h), (36, 44), method)),
                           _bits(g))


@pytest.mark.parametrize("form", ["numpy64", "numpy32", "tensor64", "tensor32"])
@pytest.mark.parametrize("batch", [None, 1, 7])
def test_host_inverse_is_the_plain_inverse(rng, form, batch):
    H = _homographies(rng, 1 if batch is None else batch)
    H = H[0] if batch is None else H
    arg = {"numpy64": H, "numpy32": H.astype(np.float32), "tensor64": torch.from_numpy(H),
           "tensor32": torch.from_numpy(H).float()}[form]
    got = twarp.host_inverse(arg)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert torch.equal(got, torch.linalg.inv(torch.from_numpy(H).float()))
    if batch is not None:      # a batch inverts each matrix as alone
        alone = torch.stack([torch.linalg.inv(torch.from_numpy(h).float()) for h in H])
        assert torch.equal(got, alone)


def test_singular_homography_raises(rng):
    singular = np.array([[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [0.0, 0.0, 1.0]])
    img = torch.from_numpy(rng.integers(0, 256, (12, 16, 3)).astype(np.uint8))
    with pytest.raises(torch.linalg.LinAlgError):
        twarp.host_inverse(singular)
    with pytest.raises(torch.linalg.LinAlgError):
        twarp.warp_perspective(img, singular, (12, 16))
    with pytest.raises(torch.linalg.LinAlgError):
        twarp.warp_perspective([img, img], np.stack([np.eye(3), singular]), (12, 16))
    with pytest.raises(torch.linalg.LinAlgError):
        trect.disparity_to_original_frame(torch.zeros(12, 16), singular, (12, 16))


def test_images_off_the_cpu_and_card_raise_before_a_launch():
    imgs = [torch.empty((8, 8, 3), dtype=torch.uint8, device="meta")] * 2
    before = LAUNCHES["warp"]
    with pytest.raises(ValueError, match="one CUDA device"):
        twarp.warp_perspective(imgs, np.stack([np.eye(3)] * 2), (8, 8))
    with pytest.raises(ValueError, match="B images"):
        twarp.warp_inverse_maps(imgs, torch.eye(3)[None], (8, 8))
    assert LAUNCHES["warp"] == before


@pytest.mark.parametrize("case", WARP_IMAGE_CASES)
def test_cpu_route_takes_what_the_twin_takes(rng, case):
    imgs = warp_images(rng, case)
    H = _homographies(rng, 2)
    before = LAUNCHES["warp"]
    got = twarp.warp_perspective(imgs, H, (36, 44), "bilinear")
    hinv = torch.linalg.inv(torch.from_numpy(H).float())
    want = torch.stack([twarp.warp_inverse_map(img, m, (36, 44)) for img, m in zip(imgs, hinv)])
    assert LAUNCHES["warp"] == before
    assert got.dtype == torch.float32 and got.shape == (2, 36, 44, *imgs[0].shape[2:])
    assert torch.equal(_bits(got), _bits(want))


def test_a_batch_of_different_channels_raises(rng):
    imgs = [torch.zeros((8, 8, 3)), torch.zeros((8, 8))]
    with pytest.raises(ValueError, match="share their channels"):
        twarp.warp_perspective(imgs, np.stack([np.eye(3)] * 2), (8, 8))
    with pytest.raises(ValueError, match="share their channels"):
        twarp.warp_perspective([imgs[0], imgs[0][..., :1]], np.stack([np.eye(3)] * 2), (8, 8))


def _scene(rng_seed=4, h=96, w=128):
    left, right, K, _, _, F, _ = nonplanar_scene(np.random.default_rng(rng_seed), h, w)
    return left, right, K, F


def test_rectify_pair_and_backwarp_equal_their_earlier_form(rng):
    left, right, _, F = _scene()
    rect = trect.rectify_pair(torch.from_numpy(left), torch.from_numpy(right), F)
    homs = rect.homographies
    for side, H in (("left", homs.H_left), ("right", homs.H_right)):
        img = torch.from_numpy(left if side == "left" else right)
        want = _old_warp(img, torch.as_tensor(H, dtype=torch.float32), rect.canvas)
        assert torch.equal(_bits(getattr(rect, side)), _bits(want)), side
    disp = torch.from_numpy(rng.uniform(-5, 30, rect.canvas).astype(np.float32))
    for compat in (None, homs.H_left):
        Hu = torch.as_tensor(homs.H_right if compat is None else compat, dtype=torch.float32)
        want = _old_warp(disp, torch.linalg.inv(Hu), (96, 128), method="nearest")
        got = trect.disparity_to_original_frame(disp, homs.H_right, (96, 128),
                                                compat_left_homography=compat)
        assert torch.equal(_bits(got), _bits(want))
    # a grey left and a colour right image: a warp each, as before
    rect = trect.rectify_pair(torch.from_numpy(left[..., 0]), torch.from_numpy(right), F)
    for side, img, H in (("left", left[..., 0], homs.H_left), ("right", right, homs.H_right)):
        want = _old_warp(torch.from_numpy(img), torch.as_tensor(H, dtype=torch.float32),
                         rect.canvas)
        assert torch.equal(_bits(getattr(rect, side)), _bits(want)), side


def test_run_batch_on_cpu_equals_its_earlier_vmap_warps(monkeypatch):
    """``run_batch``'s dense stage once vmapped ``warp_perspective`` over
    the batch with H on the device; its result must not move."""
    left, right, K, _ = _scene(4, 240, 320)
    K = K.astype(np.float32)
    fl, fr = flat_pair()
    Kf = np.array([[96.0, 0, 48], [0, 96, 32], [0, 0, 1]], np.float32)
    pairs = [StereoPair(left, right, K, K, name="scene"), StereoPair(fl, fr, Kf, Kf, name="flat")]
    config = PipelineConfig(matcher=MatcherConfig(block_size=7, max_disparity=48))
    new = tpb.run_batch(pairs, config, device="cpu")

    def earlier(images, H, out_shape, method="bilinear"):
        return vmap(lambda img, h: _old_warp(img, h, out_shape, method))(
            torch.stack(list(images)), torch.as_tensor(H))

    monkeypatch.setattr(tpb, "warp_perspective", earlier)
    monkeypatch.setattr(tpb, "host_inverse", lambda H: vmap(torch.linalg.inv)(torch.as_tensor(H)))
    old = tpb.run_batch(pairs, config, device="cpu")
    assert new.pose_ok.tolist() == old.pose_ok.tolist()
    assert new.pose_ok[0]
    np.testing.assert_array_equal(new.disparity, old.disparity)
    assert np.array_equal(new.depth.view(np.int32), old.depth.view(np.int32))
