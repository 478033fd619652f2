"""The port's uncalibrated path against the JAX package on the CPU.

* ``eight_point_fundamental`` and ``sampson_distance`` on
  ``tests/test_fundamental.py::_scene``: F equal to JAX's up to sign
  (atol 1e-4), Sampson distances to rounding;
* ``ransac_fundamental`` with JAX's threefry permutation draws carried
  across as ``samples``: the same inlier mask and F;
* the host copy ``rectify/epilines.py`` gives the original's outputs;
* ``run_uncalibrated`` on ``tests/test_uncalibrated.py::_pair``: the JAX
  test's gates (>= 50 inliers, epipolar alignment <= 1.0 px, F re-estimated,
  the three PNGs) for orb, brisk and dog, which the JAX package meets too;
* ``linear_search`` on JAX's rectified pair: >= 99.5% of JAX's disparity.

RANSAC's winner is ill-conditioned in float32 (ROADMAP, Queue 3), so the
port's default draws (a CPU ``torch.Generator``) are held to the gates,
not to JAX's F.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu.config import MatcherConfig as JaxMatcherConfig
from stereo_reconstruction_tpu.config import OrbConfig as JaxOrb
from stereo_reconstruction_tpu.config import PipelineConfig as JaxPipelineConfig
from stereo_reconstruction_tpu.pipeline_uncalibrated import run_uncalibrated as jrun
from stereo_reconstruction_tpu.pose import fundamental as jfun
from stereo_reconstruction_tpu.rectify import epilines as jepi
from stereo_reconstruction_tpu_torch.config import MatcherConfig, OrbConfig, PipelineConfig
from stereo_reconstruction_tpu_torch.ops.linear_search import linear_search
from stereo_reconstruction_tpu_torch.pipeline_uncalibrated import run_uncalibrated
from stereo_reconstruction_tpu_torch.pose import fundamental as tfun
from stereo_reconstruction_tpu_torch.rectify import epilines as tepi

from test_fundamental import _scene
from test_uncalibrated import _pair

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _up_to_sign(got, want, atol):
    err = min(np.abs(got - want).max(), np.abs(got + want).max())
    assert err <= atol, err


def jax_samples(key, num_hypotheses, n_valid):
    """JAX ``ransac_fundamental``'s draws: the first 8 of a threefry
    permutation per hypothesis key."""
    keys = jax.random.split(key, num_hypotheses)
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n_valid)[:8])(keys))


@pytest.mark.parametrize("n", [8, 30])
def test_eight_point_fundamental_equals_jax(rng, n):
    kp_l, kp_r, F_gt = _scene(rng, n=n)
    want = np.asarray(jfun.eight_point_fundamental(jnp.asarray(kp_l), jnp.asarray(kp_r)))
    got = tfun.eight_point_fundamental(_t(kp_l), _t(kp_r)).numpy()
    _up_to_sign(got, want, 1e-4)
    _up_to_sign(got, F_gt, 5e-3)                       # the JAX test's bound


def test_batched_eight_point_equals_jax(rng):
    kp_l, kp_r, _ = _scene(rng, n=40)
    idx = np.stack([rng.permutation(40)[:8] for _ in range(6)])
    sl = np.moveaxis(kp_l[:, idx], 1, 0)
    sr = np.moveaxis(kp_r[:, idx], 1, 0)
    want = np.asarray(jfun.eight_point_fundamental(jnp.asarray(sl), jnp.asarray(sr)))
    got = tfun.eight_point_fundamental(_t(sl), _t(sr)).numpy()
    for g, w in zip(got, want):
        _up_to_sign(g, w, 1e-4)


def test_sampson_distance_equals_jax(rng):
    kp_l, kp_r, F_gt = _scene(rng, n=40, outlier_frac=0.25)
    F = F_gt.astype(np.float32)
    want = np.asarray(jfun.sampson_distance(jnp.asarray(F), jnp.asarray(kp_l),
                                            jnp.asarray(kp_r)))
    got = tfun.sampson_distance(_t(F), _t(kp_l), _t(kp_r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("seed,n_valid", [(0, 80), (1, 70)])
def test_ransac_with_jax_draws_equals_jax(rng, seed, n_valid):
    kp_l, kp_r, F_gt = _scene(rng, n=80, outlier_frac=0.25)
    key = jax.random.key(seed)
    want = jfun.ransac_fundamental(key, jnp.asarray(kp_l), jnp.asarray(kp_r),
                                   num_hypotheses=64, num_matches_valid=n_valid)
    got = tfun.ransac_fundamental(_t(kp_l), _t(kp_r),
                                  _t(jax_samples(key, 64, n_valid)),
                                  num_matches_valid=n_valid)
    np.testing.assert_array_equal(got.inlier_mask.numpy(), np.asarray(want.inlier_mask))
    assert int(got.num_inliers) == int(want.num_inliers) >= 40
    assert bool(got.valid) and bool(want.valid)
    _up_to_sign(got.F.numpy(), np.asarray(want.F), 1e-4)
    _up_to_sign(got.F.numpy(), F_gt, 2e-2)             # the JAX test's bound


def test_draw_samples_are_distinct_valid_indices():
    s = tfun.draw_samples(128, 37, torch.Generator().manual_seed(3))
    assert s.shape == (128, 8) and s.dtype == torch.int64
    assert int(s.min()) >= 0 and int(s.max()) < 37
    assert all(len(set(row.tolist())) == 8 for row in s)
    again = tfun.draw_samples(128, 37, torch.Generator().manual_seed(3))
    assert torch.equal(s, again)


def test_epilines_copy_equals_the_original():
    rng = np.random.default_rng(0)
    F = rng.normal(size=(3, 3))
    pts = rng.uniform(5, 60, (14, 2))
    for which in (1, 2):
        np.testing.assert_array_equal(tepi.epipolar_lines(F, pts, which),
                                      jepi.epipolar_lines(F, pts, which))
        np.testing.assert_array_equal(tepi.epipolar_lines(F, np.vstack([pts.T, np.ones(14)]),
                                                          which),
                                      jepi.epipolar_lines(F, np.vstack([pts.T, np.ones(14)]),
                                                          which))
    np.testing.assert_array_equal(tepi.epipole(F), jepi.epipole(F))
    img_l = rng.uniform(0, 255, (64, 72, 3))
    img_r = rng.integers(0, 255, (64, 72)).astype(np.uint8)
    for draw in ("draw_epilines", "draw_rectified_epilines"):
        got = getattr(tepi, draw)(img_l, img_r, F, pts, pts + 2.0, num_lines=5, seed=3)
        want = getattr(jepi, draw)(img_l, img_r, F, pts, pts + 2.0, num_lines=5, seed=3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.uint8
            np.testing.assert_array_equal(g, w)


def _configs():
    return (PipelineConfig(matcher=MatcherConfig(max_disparity=16),
                           orb=OrbConfig(max_keypoints=256, num_levels=2)),
            JaxPipelineConfig(matcher=JaxMatcherConfig(max_disparity=16),
                              orb=JaxOrb(max_keypoints=256, num_levels=2)))


@pytest.fixture(scope="module")
def jax_orb_run():
    L, R = _pair()
    return jrun(L, R, _configs()[1], detector="orb")


@pytest.mark.parametrize("detector", ["orb", "brisk", "dog"])
def test_run_uncalibrated_meets_the_jax_gates(tmp_path, detector):
    L, R = _pair()
    out = str(tmp_path / "uncal")
    res = run_uncalibrated(L, R, _configs()[0], detector=detector, output_dir=out,
                           device="cpu")
    assert res.num_inliers >= 50
    assert res.F_rectified is not None and np.isfinite(res.F).all()
    assert np.isfinite(res.epipolar_alignment_px)
    assert res.epipolar_alignment_px <= 1.0, res.epipolar_alignment_px
    for name in ("rectified_left.png", "rectified_right.png", "disparity_linear.png"):
        assert os.path.exists(os.path.join(out, name))
    assert res.disparity.shape == res.rectified_left.shape[:2] == (192, 384)
    assert np.isfinite(res.disparity).all()


def test_run_uncalibrated_orb_matches_jax_counts(jax_orb_run):
    """With its own draws the port finds JAX's inlier count on the test
    pair, and both rectify it to within the gate."""
    L, R = _pair()
    got = run_uncalibrated(L, R, _configs()[0], detector="orb", device="cpu")
    want = jax_orb_run
    assert got.num_inliers == want.num_inliers >= 50
    assert want.epipolar_alignment_px <= 1.0
    assert got.rectified_left.shape == want.rectified_left.shape
    # the same call twice gives the same answer (the draws are seeded)
    again = run_uncalibrated(L, R, _configs()[0], detector="orb", device="cpu")
    np.testing.assert_array_equal(again.F, got.F)
    np.testing.assert_array_equal(again.disparity, got.disparity)


def test_linear_search_on_jax_rectified_pair(jax_orb_run):
    want = jax_orb_run.disparity
    got = linear_search(_t(jax_orb_run.rectified_left), _t(jax_orb_run.rectified_right),
                        smooth_factor=0.9, search_range=16).numpy()
    agree = np.mean(got == want)
    assert agree >= 0.995, agree


def test_run_uncalibrated_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    L, R = _pair()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_uncalibrated(L, R, _configs()[0])


def test_unknown_detector_raises():
    L, R = _pair()
    with pytest.raises(ValueError, match="unknown detector"):
        run_uncalibrated(L, R, _configs()[0], detector="sift", device="cpu")
