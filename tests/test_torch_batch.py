"""The port's batched main path against the JAX package's on the CPU.

* The batched pose, ``torch.func.vmap`` of ``estimate_pose_from_matches``
  on the ``tests/test_batch.py`` fixture (a healthy element and one with 5
  valid matches), JAX's per-element draws carried across: the same
  ``valid`` flags, the healthy element within the tolerances of
  ``tests/test_torch_pose.py`` (rotation and translation direction 1e-3,
  reprojection errors 5e-3 px).
* ``run_batch`` with B = 2 at 240x320: the non-planar scene of
  ``chip_smoke.nonplanar_scene`` and the flat-row pair, which has no
  keypoints and so a failed pose. D = 80, block 7. JAX's per-pair draws
  (``fold_in(key(seed), i)``) are carried across. Held: the same
  ``pose_ok``, disparity agreement >= 0.99 per pair, metrics within 1%,
  the same keys, int16-exact disparities (measured: agreement 0.99712 and
  1.00000). The scene is seed 5: the RANSAC winner is an argmax over
  ill-conditioned float32 solves, and with pair 0's draws of JAX's
  ``run_batch`` (not those of ``run_pair``) the two packages pick the same
  winner on some scene seeds only; seed 5 is one (185 inliers each).
* The degenerate pair is masked alone: the scene's disparity and metrics
  in the masked batch agree with those of a batch of the scene alone (same
  draws, same padded shape) to >= 99.5% and 0.1%. Not bit for bit: BA's
  batched solves round differently at B = 2 and B = 1, which moves the
  pose slightly and flips 0.03% of the disparities (measured agreement
  0.99974).
* ``run_batches`` equals ``run_batch`` per batch under the port's draw
  rule (``batch_uniforms``); a ``mesh=`` that is not a ``Mesh`` raises
  (``tests/test_torch_batch_mesh.py`` runs the mesh path).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu import config as jcfg
from stereo_reconstruction_tpu import pipeline_batch as jpb
from stereo_reconstruction_tpu.data.records import StereoPair as JaxStereoPair
from stereo_reconstruction_tpu.pose.pipeline import estimate_pose_from_matches as jestimate
from stereo_reconstruction_tpu_torch import pipeline as tpipe
from stereo_reconstruction_tpu_torch import pipeline_batch as tpb
from stereo_reconstruction_tpu_torch.config import from_jax_config
from stereo_reconstruction_tpu_torch.data.records import StereoPair
from stereo_reconstruction_tpu_torch.pose.pipeline import estimate_pose_from_matches

from test_batch import _synthetic_matches

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from chip_smoke import flat_pair, nonplanar_disparity, nonplanar_scene  # noqa: E402

torch.set_num_threads(1)

JAX_CONFIG = jcfg.PipelineConfig(matcher=jcfg.MatcherConfig(block_size=7, max_disparity=80))
CONFIG = from_jax_config(JAX_CONFIG)
AGREEMENT = 0.99


def jax_key_uniforms(key, num_hypotheses, n):
    """JAX's RANSAC uniforms for the pose key ``key`` (``pose/ransac.py``)."""
    keys = jax.random.split(key, num_hypotheses)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))


def jax_batch_uniforms(config, batch_size, key=None):
    """JAX ``run_batch``'s draws, pair i under ``fold_in(key, i)``, as the
    port's (B, num_hypotheses, max_keypoints) ``uniforms``."""
    key = jax.random.key(config.seed) if key is None else key
    return np.stack([jax_key_uniforms(jax.random.fold_in(key, i),
                                      config.ransac.num_hypotheses,
                                      config.frontend.max_keypoints)
                     for i in range(batch_size)])


def _unit(t):
    t = np.asarray(t, np.float64)
    return t / np.linalg.norm(t)


def test_batched_pose_masks_the_degenerate_element_like_jax():
    rng = np.random.default_rng(3)
    n = 64
    kl, kr, K = _synthetic_matches(rng, n, noise=0.1)
    jconfig = jcfg.PipelineConfig(
        ransac=jcfg.RansacConfig(num_hypotheses=32),
        ba=jcfg.BundleAdjustmentConfig(max_iterations=4, num_points=24))
    keys = jax.random.split(jax.random.key(0), 2)
    want = jax.vmap(lambda k, ml, mr, nv: jestimate(
        k, ml, mr, jnp.asarray(K), jnp.asarray(K), jconfig, num_matches_valid=nv))(
        keys, jnp.stack([kl, kl]), jnp.stack([kr, kr]), jnp.array([n, 5]))

    u = torch.from_numpy(np.stack([jax_key_uniforms(k, 32, n) for k in keys]))
    Kt = torch.from_numpy(K.astype(np.float32))
    config = from_jax_config(jconfig)
    got = torch.func.vmap(lambda ml, mr, nv, uu: estimate_pose_from_matches(
        ml, mr, Kt, Kt, config, num_matches_valid=nv, uniforms=uu))(
        torch.from_numpy(np.stack([kl, kl])), torch.from_numpy(np.stack([kr, kr])),
        torch.tensor([n, 5]), u)

    assert got.valid.tolist() == np.asarray(want.valid).tolist() == [True, False]
    assert got.enough_points.tolist() == np.asarray(want.enough_points).tolist()
    pg, pw = got.pose[0].numpy(), np.asarray(want.pose[0])
    assert np.abs(pg[:3, :3] - pw[:3, :3]).max() <= 1e-3
    assert np.abs(_unit(pg[:3, 3]) - _unit(pw[:3, 3])).max() <= 1e-3
    for err in ("reproj_error_8pt", "reproj_error_ba"):
        assert abs(float(getattr(got, err)[0]) - float(getattr(want, err)[0])) <= 5e-3, err
    assert float(got.reproj_error_ba[0]) < 2.0


def _same_pose(got, want, tol=1e-3):
    """Rotation and translation direction within ``tol`` (BA leaves the
    translation's scale free)."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got[:3, :3] - want[:3, :3]).max() <= tol
    assert np.abs(_unit(got[:3, 3]) - _unit(want[:3, 3])).max() <= tol


def _pairs():
    left, right, K, _, _, F, src = nonplanar_scene(np.random.default_rng(5), 240, 320)
    gt, mask = nonplanar_disparity(src, F)
    K = K.astype(np.float32)
    scene = dict(image_left=left, image_right=right, intrinsics_left=K, intrinsics_right=K,
                 disp_right_gt=gt, mask_right_nocc=mask, name="scene", ndisp=80)
    fl, fr = flat_pair()
    Kf = np.array([[96.0, 0, 48], [0, 96, 32], [0, 0, 1]], np.float32)
    flat = dict(image_left=fl, image_right=fr, intrinsics_left=Kf, intrinsics_right=Kf,
                name="flat")
    return scene, flat


@pytest.fixture(scope="module")
def batches():
    """JAX's run_batch and the port's on [scene, flat] with JAX's draws, and
    the port's on [scene] alone with pair 0's draws."""
    scene, flat = _pairs()
    want = jpb.run_batch([JaxStereoPair(**scene), JaxStereoPair(**flat)], JAX_CONFIG)
    u = torch.from_numpy(jax_batch_uniforms(JAX_CONFIG, 2))
    got = tpb.run_batch([StereoPair(**scene), StereoPair(**flat)], CONFIG, uniforms=u,
                        device="cpu")
    alone = tpb.run_batch([StereoPair(**scene)], CONFIG, uniforms=u[:1], device="cpu")
    return want, got, alone


def test_run_batch_matches_jax(batches):
    want, got, _ = batches
    assert got.disparity.shape == want.disparity.shape == (2, 240, 384)
    assert got.pose_ok.tolist() == np.asarray(want.pose_ok).tolist() == [True, False]
    for i in range(2):
        agree = np.mean(got.disparity[i] == want.disparity[i])
        assert agree >= AGREEMENT, f"pair {i}: disparity agreement {agree:.5f}"
        assert set(got.metrics[i]) == set(want.metrics[i])
        for k, v in want.metrics[i].items():
            assert abs(got.metrics[i][k] - v) <= 0.01 * max(1.0, abs(v)), (i, k)
    assert np.mean(got.disparity[0] > 0) > 0.5            # the scene is really matched
    assert got.timings.keys() == want.timings.keys() == {"pose", "loop_zhang_host", "dense"}
    assert got.metrics[0]["bad_percent"] < 20.0


def test_run_batch_outputs_keep_their_dtypes(batches):
    want, got, _ = batches
    assert got.disparity.dtype == want.disparity.dtype == np.float32
    # the disparities went through int16 exactly
    np.testing.assert_array_equal(got.disparity, np.rint(got.disparity))
    assert np.abs(got.disparity).max() < 2**15
    assert got.depth.dtype == np.float32 and got.depth.shape == got.disparity.shape
    agree = got.disparity == want.disparity
    np.testing.assert_array_equal(np.isneginf(got.depth[agree]),
                                  np.isneginf(want.depth[agree]))
    # the outlier clamp reads means over 500 px windows, so where the
    # disparities agree the depth still moves with the pixels that differ
    fin = agree & np.isfinite(want.depth)
    np.testing.assert_allclose(got.depth[fin], want.depth[fin], rtol=1e-3)
    assert got.pose.pose.shape == (2, 4, 4) and got.pose.valid.shape == (2,)
    assert got.pose_ok.dtype == np.bool_


def test_degenerate_pair_is_masked_without_touching_its_neighbour(batches):
    _, got, alone = batches
    assert alone.pose_ok.tolist() == [True]
    assert got.metrics[1]["pose_ok"] == 0.0 and "bad_percent" not in got.metrics[1]
    agree = np.mean(got.disparity[0] == alone.disparity[0])
    assert agree >= 0.995, f"disparity agreement {agree:.5f}"
    _same_pose(got.pose.pose[0], alone.pose.pose[0])
    for k, v in alone.metrics[0].items():
        assert abs(got.metrics[0][k] - v) <= 1e-3 * max(1.0, abs(v)), k
    # the failed pair is matched raw, inside the same dense stage
    assert np.mean(got.disparity[1][:64, :80] == 5) > 0.9


def test_a_loop_zhang_failure_masks_its_pair(monkeypatch):
    """A pair whose homographies cannot be computed from a valid pose is
    matched raw, like a pair whose pose failed, and still scored."""
    scene, flat = _pairs()
    fl = dict(flat, disp_right_gt=np.full((64, 96), 5.0, np.float32),
              mask_right_nocc=np.full((64, 96), 255, np.uint8))

    def degenerate(F, *shapes):
        raise np.linalg.LinAlgError("matrix not PSD within tolerance")

    monkeypatch.setattr(tpb, "loop_zhang_homographies", degenerate)
    res = tpb.run_batch([StereoPair(**fl), StereoPair(**scene)], CONFIG, device="cpu")
    assert res.pose_ok.tolist() == [False, False]
    assert bool(res.pose.valid[1])                       # the pose itself was fine
    assert res.metrics[1]["pose_ok"] == 0.0 and "bad_percent" in res.metrics[1]
    assert res.metrics[0]["bad_percent"] < 10.0         # the raw flat pair matches


def test_run_batches_equals_run_batch_per_batch():
    scene, flat = _pairs()
    groups = [[StereoPair(**scene)], [StereoPair(**flat), StereoPair(**flat)]]
    piped = tpb.run_batches(groups, CONFIG, fetch_depth=False, device="cpu")
    for i, group in enumerate(groups):
        u = tpb.batch_uniforms(CONFIG, len(group), i)
        seq = tpb.run_batch(group, CONFIG, uniforms=u, device="cpu")
        np.testing.assert_array_equal(piped[i].disparity, seq.disparity)
        assert piped[i].depth is None and seq.depth is not None
        assert piped[i].metrics == seq.metrics
        assert set(piped[i].timings) == {"pose_dispatch", "pose", "loop_zhang_host", "dense"}
    assert piped[0].pose_ok.tolist() == [True] and piped[1].pose_ok.tolist() == [False, False]


def test_batch_uniforms_rule():
    a = tpb.batch_uniforms(CONFIG, 3, 0)
    assert a.shape == (3, CONFIG.ransac.num_hypotheses, CONFIG.frontend.max_keypoints)
    assert a.dtype == torch.float32 and a.device.type == "cpu"
    assert torch.equal(a, tpb.batch_uniforms(CONFIG, 3, 0))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], tpb.batch_uniforms(CONFIG, 1, 1)[0])
    # the first pairs of a larger batch draw the same as a smaller batch
    assert torch.equal(a[:2], tpb.batch_uniforms(CONFIG, 2, 0))


def test_run_batch_refuses_a_mesh_and_bad_draws():
    scene, _ = _pairs()
    pair = StereoPair(**scene)
    # a mesh is a parallel.mesh.Mesh (tests/test_torch_batch_mesh.py runs one)
    with pytest.raises(TypeError, match="mesh must be"):
        tpb.run_batch([pair], CONFIG, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="mesh must be"):
        tpb.run_batches([[pair]], CONFIG, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="uniforms"):
        tpb.run_batch([pair], CONFIG, uniforms=torch.zeros(2, 3, 4), device="cpu")


def test_run_batch_defaults_to_the_card():
    scene, _ = _pairs()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpb.run_batch([StereoPair(**scene)], CONFIG)


def test_pose_batch_equals_the_per_pair_pose():
    """The batched pose is one vmapped program, and each of its elements is
    the per-pair ``pose_device`` on that pair's images and draws."""
    scene, flat = _pairs()
    pairs = [StereoPair(**scene), StereoPair(**scene)]
    images = torch.stack([torch.stack([torch.from_numpy(p.image_left),
                                       torch.from_numpy(p.image_right)]) for p in pairs]
                         ).to(torch.float32)
    K = torch.from_numpy(np.stack([p.intrinsics_left for p in pairs]))
    u = tpb.batch_uniforms(CONFIG, 2)
    got = tpb.pose_batch(images[:, 0], images[:, 1], K, K, u, CONFIG)
    for i in range(2):
        one = tpipe.pose_device(images[i], K[i], K[i], u[i], CONFIG)
        assert bool(got.valid[i]) == bool(one.valid)
        assert int(got.num_inliers[i]) == int(one.num_inliers)
        _same_pose(got.pose[i], one.pose)
