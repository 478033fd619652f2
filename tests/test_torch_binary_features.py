"""The port's ORB and BRISK frontends and binary matcher against the JAX
package on the CPU.

The sampling patterns must be equal. At one level (ORB ``num_levels=1``,
BRISK ``octaves=1``) the keypoints and descriptors must be equal. Over the
full pyramids the levels come from antialiased bilinear resizes
(``jax.image.resize(..., "linear")`` against ``F.interpolate(...,
antialias=True)``, within 2e-3 of each other), whose residue can flip a
FAST test at a few pixels: there >= 95% of JAX's valid keypoints must be
found at the same position, with >= 99.9% of their descriptor bits
equal. ``match_descriptors_binary`` on JAX's keypoints carried across must
give JAX's matches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu.config import BriskConfig as JaxBrisk
from stereo_reconstruction_tpu.config import OrbConfig as JaxOrb
from stereo_reconstruction_tpu.ops import binary_features as jbf
from stereo_reconstruction_tpu.ops import matching as jmatch
from stereo_reconstruction_tpu_torch.config import BriskConfig, OrbConfig
from stereo_reconstruction_tpu_torch.ops import binary_features as tbf
from stereo_reconstruction_tpu_torch.ops import matching as tmatch
from stereo_reconstruction_tpu_torch.ops.features import Keypoints

from test_binary_features import _texture

torch.set_num_threads(1)


def _square(h=96, lo=32, hi=64):
    img = np.zeros((h, h), np.float32)
    img[lo:hi, lo:hi] = 200.0
    return img


def _shifted(seed, dx, h=160, w=224):
    base = _texture(h, w, seed=seed).astype(np.float32)
    return base[16:h - 16, 16:w - 16], base[16:h - 16, 16 + dx:w - 16 + dx]


DETECTORS = {
    "orb": (jbf.detect_and_describe_orb, JaxOrb, tbf.detect_and_describe_orb, OrbConfig),
    "brisk": (jbf.detect_and_describe_brisk, JaxBrisk, tbf.detect_and_describe_brisk,
              BriskConfig),
}
ONE_LEVEL = {"orb": dict(num_levels=1), "brisk": dict(octaves=1)}


def _both(detector, img, **kw):
    jdet, jcfg, tdet, tcfg = DETECTORS[detector]
    want = jdet(jnp.asarray(img), jcfg(**kw))
    got = tdet(torch.from_numpy(np.ascontiguousarray(img)), tcfg(**kw))
    return got, Keypoints(*(np.asarray(x) for x in want))


def test_brief_pattern_equals_jax():
    for bits, patch in [(256, 21), (128, 31)]:
        np.testing.assert_array_equal(tbf._brief_pattern(bits, patch),
                                      jbf._brief_pattern(bits, patch))


@pytest.mark.parametrize("scale,bits", [(1.0, 512), (1.5, 256)])
def test_brisk_pattern_equals_jax(scale, bits):
    for g, w in zip(tbf._brisk_pattern(scale, bits), jbf._brisk_pattern(scale, bits)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", [(75, 90), (128, 184), (40, 52)])
@pytest.mark.parametrize("src_h,src_w", [(128, 184), (150, 180)])
def test_resize_against_jax_image_resize(rng, src_h, src_w, shape):
    img = rng.uniform(0, 255, (src_h, src_w)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), shape, "linear"))
    got = tbf._resize(torch.from_numpy(img), shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("image", ["square", "texture"])
@pytest.mark.parametrize("detector", ["orb", "brisk"])
def test_one_level_equals_jax(detector, image):
    img = _square() if image == "square" else _shifted(7, 0)[0]
    k = 32 if image == "square" else 256
    got, want = _both(detector, img, max_keypoints=k, **ONE_LEVEL[detector])
    assert got.valid.sum() == want.valid.sum() >= 4
    # the square's corners tie in exact arithmetic, so rounding orders
    # them: compare keypoint by keypoint in xy order
    g = Keypoints(*(x.numpy()[got.valid.numpy()] for x in got))
    w = Keypoints(*(x[want.valid] for x in want))
    gi, wi = np.lexsort(g.xy.T), np.lexsort(w.xy.T)
    np.testing.assert_array_equal(g.xy[gi], w.xy[wi])
    np.testing.assert_array_equal(g.scale[gi], w.scale[wi])
    if image == "texture":
        np.testing.assert_array_equal(g.descriptors[gi], w.descriptors[wi])
    else:
        # on the square's flat faces two samples tie in exact arithmetic,
        # and the blurs' rounding decides a few of BRISK's bits
        assert np.mean(g.descriptors[gi] == w.descriptors[wi]) >= 0.99
    np.testing.assert_allclose(g.response[gi], w.response[wi], rtol=1e-5)
    np.testing.assert_allclose(g.orientation[gi], w.orientation[wi], atol=1e-4)


@pytest.mark.parametrize("detector,kw,size", [
    ("orb", dict(), (160, 224)),
    ("brisk", dict(), (288, 288)),
])
def test_full_pyramid_overlaps_jax(detector, kw, size):
    img = _shifted(23, 0, *size)[0]
    got, want = _both(detector, img, max_keypoints=256, **kw)
    gv = got.valid.numpy()
    want_xy = {tuple(p): i for i, p in enumerate(want.xy[want.valid])}
    got_xy = {tuple(p): i for i, p in enumerate(got.xy.numpy()[gv])}
    common = [p for p in want_xy if p in got_xy]
    assert len(np.unique(want.scale[want.valid])) >= 2      # several levels won
    assert len(common) >= 0.95 * len(want_xy), (len(common), len(want_xy))
    wd = want.descriptors[want.valid][[want_xy[p] for p in common]]
    gd = got.descriptors.numpy()[gv][[got_xy[p] for p in common]]
    assert np.mean(wd == gd) >= 0.999


@pytest.mark.parametrize("detector", ["orb", "brisk"])
def test_too_small_image_raises(detector):
    _, _, tdet, tcfg = DETECTORS[detector]
    with pytest.raises(ValueError, match=f"smaller than one {detector.upper()} level"):
        tdet(torch.zeros((24, 24)), tcfg())


@pytest.mark.parametrize("detector", ["orb", "brisk"])
def test_binary_matching_on_jax_keypoints_equals_jax(detector):
    left, right = _shifted(11, 7)
    jdet, jcfg, _, _ = DETECTORS[detector]
    cfg = jcfg(max_keypoints=256, **ONE_LEVEL[detector])
    kl, kr = jdet(jnp.asarray(left), cfg), jdet(jnp.asarray(right), cfg)
    want = jmatch.match_descriptors_binary(kl, kr)

    def carry(kp):
        return Keypoints(*(torch.from_numpy(np.array(x)) for x in kp))

    got = tmatch.match_descriptors_binary(carry(kl), carry(kr))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.sum() >= 30
    np.testing.assert_array_equal(got.right_xy.numpy(), np.asarray(want.right_xy))
    np.testing.assert_array_equal(got.distance.numpy(), np.asarray(want.distance))


def test_hamming_matmul_equals_popcount():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2, (64, 256)).astype(np.float32)
    b = rng.integers(0, 2, (64, 256)).astype(np.float32)
    xy = torch.arange(64, dtype=torch.float32)[:, None].expand(64, 2).clone()
    ones = torch.ones(64)
    kpa = Keypoints(xy=xy, scale=ones, response=ones, orientation=0 * ones,
                    descriptors=torch.from_numpy(a), valid=torch.ones(64, dtype=torch.bool))
    m = tmatch.match_descriptors_binary(kpa, kpa._replace(descriptors=torch.from_numpy(b)))
    ham = (a[:, None, :] != b[None, :, :]).sum(-1)        # exact popcount
    np.testing.assert_array_equal(m.distance.numpy(),
                                  ham[np.arange(64), ham.argmin(1)].astype(np.float32))
