"""The port's SIFT-style frontend (``ops/features.py``) and descriptor
matching (``ops/matching.py``) against the JAX package's on the CPU, on
``tests/test_features.py::_textured_image``.

Measured: the same valid count, every valid slot with xy within 3.1e-5 px
and descriptors within 1.3e-6 of JAX (the tolerances are 1e-3 px and 1e-4
on >= 98% of slots, which leaves room for a top-K tie or an orientation
bin decided by one rounding step; none occurs on these images). Matching
on JAX's own keypoints gives JAX's valid mask and right positions exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu.config import FrontendConfig
from stereo_reconstruction_tpu.ops import features as jf
from stereo_reconstruction_tpu.ops import matching as jm
from stereo_reconstruction_tpu_torch.config import from_jax_config
from stereo_reconstruction_tpu_torch.ops import features as tf
from stereo_reconstruction_tpu_torch.ops import matching as tm

from test_features import _textured_image

torch.set_num_threads(1)

CONFIGS = {
    "small": FrontendConfig(max_keypoints=200, num_octaves=3),
    "default": FrontendConfig(),
}


def _port_config(cfg):
    return from_jax_config({"frontend": dataclasses.asdict(cfg)}).frontend


def _jax_detect(img, cfg):
    with jax.default_matmul_precision("highest"):
        return jf.detect_and_describe(jnp.asarray(img), cfg)


def test_rgb_to_gray_and_blur(rng):
    img = rng.integers(0, 256, (40, 52, 3)).astype(np.uint8)
    gray = tf.rgb_to_gray(torch.from_numpy(img))
    np.testing.assert_array_equal(gray.numpy(), np.asarray(jf.rgb_to_gray(jnp.asarray(img))))
    for sigma in (1.6, 1.2262, 3.0898):
        want = jf.gaussian_blur(jnp.asarray(gray.numpy()), sigma)
        np.testing.assert_allclose(tf.gaussian_blur(gray, sigma).numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-3)


def test_card_blur_matches_jax_and_ignores_the_batch(rng):
    """The card's blur (``blur_in_tap_order``, run here on the CPU) within
    the CPU blur's tolerance of JAX's, and bit-equal for an image alone and
    inside a batch of three."""
    imgs = torch.from_numpy(rng.uniform(0, 255, (3, 40, 52)).astype(np.float32))
    for sigma in (1.6, 1.2262, 3.0898):
        got = tf.blur_in_tap_order(imgs, sigma)
        want = jf.gaussian_blur(jnp.asarray(imgs[1].numpy()), sigma)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)
        assert torch.equal(tf.blur_in_tap_order(imgs[1], sigma), got[1])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_detect_and_describe_matches_jax(rng, name):
    img = _textured_image(rng)
    cfg = CONFIGS[name]
    want = _jax_detect(img, cfg)
    got = tf.detect_and_describe(torch.from_numpy(img), _port_config(cfg))
    valid = np.asarray(want.valid)
    assert valid.sum() > 30
    assert got.valid.numpy().sum() == valid.sum()
    xy_ok = np.abs(got.xy.numpy() - np.asarray(want.xy)).max(-1) <= 1e-3
    desc_ok = np.abs(got.descriptors.numpy() - np.asarray(want.descriptors)).max(-1) <= 1e-4
    assert (xy_ok & desc_ok)[valid].mean() >= 0.98
    np.testing.assert_allclose(np.linalg.norm(got.descriptors.numpy()[valid], axis=1), 1.0,
                               atol=1e-3)


def test_batched_pair_equals_single_images(rng):
    left = _textured_image(rng)
    right = np.roll(left, -7, axis=1)
    cfg = _port_config(CONFIGS["small"])
    pair = tf.detect_and_describe_batch(torch.from_numpy(np.stack([left, right])), cfg)
    for i, img in enumerate((left, right)):
        one = tf.detect_and_describe(torch.from_numpy(img), cfg)
        for field in one._fields:
            np.testing.assert_allclose(getattr(pair, field)[i].numpy(),
                                       getattr(one, field).numpy(), atol=1e-6)


@pytest.mark.parametrize("mutual_check", [True, False])
def test_match_descriptors_on_jax_keypoints(rng, mutual_check):
    img = _textured_image(rng, h=160, w=220)
    right = np.roll(img, -18, axis=1)
    cfg = FrontendConfig(max_keypoints=200, num_octaves=3, ratio_threshold=0.8,
                         mutual_check=mutual_check)
    kp_l, kp_r = _jax_detect(img, cfg), _jax_detect(right, cfg)
    with jax.default_matmul_precision("highest"):
        want = jm.match_descriptors(kp_l, kp_r, cfg)
    carried = [tf.Keypoints(*(torch.from_numpy(np.array(x)) for x in kp))
               for kp in (kp_l, kp_r)]
    got = tm.match_descriptors(*carried, _port_config(cfg))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.right_xy.numpy(), np.asarray(want.right_xy))
    assert got.valid.numpy().sum() >= 15
    left_h, right_h, valid = tm.matches_to_homogeneous(got)
    jl, jr, jv = jm.matches_to_homogeneous(want)
    np.testing.assert_array_equal(left_h.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(right_h.numpy(), np.asarray(jr))


def test_duplicate_positions_keep_the_first(rng):
    xy = rng.uniform(0, 100, (12, 2)).astype(np.float32)
    xy[7] = xy[2]
    xy[9] = xy[2] + 5e-5
    valid = np.ones(12, bool)
    valid[4] = False
    xy[5] = xy[4]
    got = tm._filter_duplicate_positions(torch.from_numpy(xy), torch.from_numpy(valid))
    want = jm._filter_duplicate_positions(jnp.asarray(xy), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[7] and not got[9] and got[2] and got[5]
