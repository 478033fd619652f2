"""``run_batch`` / ``run_batches`` over a mesh's ``data`` axis on the CPU.

The pairs are those of ``tests/test_torch_batch.py`` (240x320, D = 80,
block 7): the non-planar scene of seed 5 and the flat-row pair, whose pose
fails.

* (a) The port's ``run_batch([scene, flat], mesh=make_mesh(data=2,
  tile=1, devices=["cpu"] * 2))`` against JAX's ``run_batch`` on
  ``make_mesh(data=2, tile=1, devices=jax.devices()[:2])``, JAX's draws
  carried across: the gates of ``test_run_batch_matches_jax`` (the same
  ``pose_ok``, agreement >= ``AGREEMENT`` per pair, metrics within 1%, the
  same timing keys). Each shard of the port holds one pair, so its BA
  solves at B = 1 where JAX's at B = 2. The failed pair's
  ``reproj_error_ba`` is BA over a support set of zero-weight padding:
  rounding noise that moves with B in JAX itself (JAX 2.4e-6 unsharded,
  0.0256 on its mesh, held in (g)), so it is held under 0.05 px in both
  packages rather than within 1% of JAX's (the port: 8.0e-6 on the mesh,
  5.6e-6 unsharded). The scene agrees 0.99974 with the port's unsharded
  run.
* (b) ``[scene, flat, scene, flat]`` on ``data=2`` equals, field by field
  and bit for bit, each half run alone with its slice of the draws (each
  half's own padding is the whole batch's here).
* (c) A mixed-size batch, ``[flat, scene]``: every shard is padded to the
  whole batch's (240, 384), the flat shard equals that pair run alone
  padded to it, and each pair agrees >= 99.5% with the unsharded run (the
  gate ``chip_smoke.py`` [batch] applies to B = 1 against B = 4; BA's
  batched solves round apart at another B; measured 1.0 and 0.99974).
  The scene takes JAX's draws of pair 0, with which its pose is right
  (bad-2.0 11.7%); draws that give a wrong pose are (g)'s.
* (d) ``tile=2`` equals ``tile=1``: a data block is computed once, on its
  ``tile=0`` device.
* (e) ``run_batches(mesh=)`` equals ``run_batch(mesh=)`` per batch.
* (f) B not a multiple of ``data`` raises ``ValueError`` naming both; a
  ``multihost.ProcessGroupMesh`` (a gloo world of one) raises
  ``NotImplementedError`` with its reason.
* (g) Draws with which one BA round poses the scene wrong. With a wrong
  pose the disparities follow every rounding of it, and JAX does not hold
  (c)'s 99.5% gate between B = 2 unsharded and B = 1 a shard.
  ``[flat, scene]`` under the JAX keys 5 and 10 (the scene takes
  ``fold_in(key, 1)``), the draws carried across: both packages give the
  same ``pose_ok``; JAX's scene is wrong (bad-2.0 71.1 / 71.6% and 41.7 /
  93.8%, unsharded / mesh) and moves more than the gate (agreement 0.95033
  and 0.33047). The port continues BA there while it has not converged
  (``settle_pose``; one round gave 64.6 / 64.6% and 96.0 / 95.9%, key 10
  converges in the fourth), so its scene is right (bad-2.0 11.68 / 11.67%
  and 12.09 / 12.03%) and holds the gate (0.99962 and 0.99682). The failed
  pair's ``reproj_error_ba`` moves by more than the 1% gate in JAX. Under
  the port's own draws (``batch_uniforms``, pair 1), wrong after one round
  (bad-2.0 81.3 / 80.7%, agreement 0.93892), the scene is right too
  (10.34 / 10.34%, agreement 0.99992).
"""

import jax
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu import pipeline_batch as jpb
from stereo_reconstruction_tpu.data.records import StereoPair as JaxStereoPair
from stereo_reconstruction_tpu.parallel import make_mesh as jax_make_mesh
from stereo_reconstruction_tpu_torch import pipeline_batch as tpb
from stereo_reconstruction_tpu_torch.data.records import StereoPair, pad_to
from stereo_reconstruction_tpu_torch.parallel import make_mesh

from test_torch_batch import AGREEMENT, CONFIG, JAX_CONFIG, _pairs, jax_batch_uniforms

torch.set_num_threads(1)


def _mesh(data=2, tile=1):
    return make_mesh(data=data, tile=tile, devices=["cpu"] * (data * tile))


def _assert_equal(got, want):
    """Two BatchResults equal field by field, bit for bit."""
    np.testing.assert_array_equal(got.disparity, want.disparity)
    np.testing.assert_array_equal(got.depth, want.depth)
    assert got.pose_ok.tolist() == want.pose_ok.tolist()
    assert got.metrics == want.metrics
    assert got.pose._fields == want.pose._fields
    for name, g, w in zip(got.pose._fields, got.pose, want.pose):
        assert torch.equal(g, w), name


@pytest.fixture(scope="module")
def four():
    """[scene, flat, scene, flat] on a data=2, tile=1 mesh, and its draws."""
    scene, flat = _pairs()
    pairs = [StereoPair(**scene), StereoPair(**flat)] * 2
    u = tpb.batch_uniforms(CONFIG, 4)
    return pairs, u, tpb.run_batch(pairs, CONFIG, uniforms=u, mesh=_mesh())


def test_mesh_run_batch_matches_jax():
    scene, flat = _pairs()
    want = jpb.run_batch([JaxStereoPair(**scene), JaxStereoPair(**flat)], JAX_CONFIG,
                         mesh=jax_make_mesh(data=2, tile=1, devices=jax.devices()[:2]))
    u = torch.from_numpy(jax_batch_uniforms(JAX_CONFIG, 2))
    # with a mesh the devices are the mesh's: the default device="cuda" is
    # not consulted
    got = tpb.run_batch([StereoPair(**scene), StereoPair(**flat)], CONFIG, uniforms=u,
                        mesh=_mesh())
    assert got.disparity.shape == want.disparity.shape == (2, 240, 384)
    assert got.pose_ok.tolist() == np.asarray(want.pose_ok).tolist() == [True, False]
    for i in range(2):
        agree = np.mean(got.disparity[i] == want.disparity[i])
        assert agree >= AGREEMENT, f"pair {i}: disparity agreement {agree:.5f}"
        assert set(got.metrics[i]) == set(want.metrics[i])
        for k, v in want.metrics[i].items():
            if k == "reproj_error_ba" and not got.pose_ok[i]:
                # BA over padding: rounding noise that moves with B in JAX too (g)
                assert got.metrics[i][k] <= 0.05 and v <= 0.05, (i, k, v)
            else:
                assert abs(got.metrics[i][k] - v) <= 0.01 * max(1.0, abs(v)), (i, k)
    assert got.timings.keys() == want.timings.keys() == {"pose", "loop_zhang_host", "dense"}
    assert got.pose.pose.shape == (2, 4, 4) and got.pose.valid.tolist() == [True, False]


def test_mesh_shards_equal_their_halves_run_alone(four):
    pairs, u, res = four
    assert res.disparity.shape == res.depth.shape == (4, 240, 384)
    assert res.pose_ok.tolist() == [True, False, True, False]
    np.testing.assert_array_equal(res.disparity, np.rint(res.disparity))
    assert set(res.timings) == {"pose", "loop_zhang_host", "dense"}
    halves = [tpb.run_batch(pairs[2 * i:2 * i + 2], CONFIG, uniforms=u[2 * i:2 * i + 2],
                            device="cpu") for i in range(2)]
    joined = tpb.BatchResult(
        disparity=np.concatenate([h.disparity for h in halves]),
        depth=np.concatenate([h.depth for h in halves]),
        pose=type(halves[0].pose)(*(torch.cat(f) for f in zip(*(h.pose for h in halves)))),
        pose_ok=np.concatenate([h.pose_ok for h in halves]),
        metrics=halves[0].metrics + halves[1].metrics, timings={})
    _assert_equal(res, joined)


def test_mesh_pads_every_shard_to_the_whole_batch():
    scene, flat = _pairs()
    pairs = [StereoPair(**flat), StereoPair(**scene)]
    u = torch.from_numpy(jax_batch_uniforms(JAX_CONFIG, 2)).flip(0).contiguous()
    sharded = tpb.run_batch(pairs, CONFIG, uniforms=u, mesh=_mesh())
    whole = tpb.run_batch(pairs, CONFIG, uniforms=u, device="cpu")
    assert sharded.disparity.shape == whole.disparity.shape == (2, 240, 384)
    assert sharded.pose_ok.tolist() == whole.pose_ok.tolist() == [False, True]
    assert sharded.metrics[1]["bad_percent"] < 20.0
    for i in range(2):
        agree = np.mean(sharded.disparity[i] == whole.disparity[i])
        assert agree >= 0.995, f"pair {i}: agreement {agree:.5f} with the unsharded run"
    # the flat pair's shard is that pair alone on the whole batch's canvas,
    # not on its own (64, 128)
    alone = tpb.run_batch([pad_to(pairs[0], 240, 384)], CONFIG, uniforms=u[:1],
                          device="cpu")
    np.testing.assert_array_equal(sharded.disparity[:1], alone.disparity)
    assert tpb.run_batch(pairs[:1], CONFIG, uniforms=u[:1],
                         device="cpu").disparity.shape == (1, 64, 128)


def test_mesh_tiles_do_not_change_the_result(four):
    pairs, u, res = four
    _assert_equal(tpb.run_batch(pairs, CONFIG, uniforms=u, mesh=_mesh(tile=2)), res)


def test_mesh_run_batches_equals_run_batch_per_batch(four):
    pairs, _, _ = four
    groups = [pairs[:2], [pairs[1], pairs[1]]]
    piped = tpb.run_batches(groups, CONFIG, mesh=_mesh())
    for i, group in enumerate(groups):
        seq = tpb.run_batch(group, CONFIG, uniforms=tpb.batch_uniforms(CONFIG, 2, i),
                            mesh=_mesh())
        _assert_equal(piped[i], seq)
        assert set(piped[i].timings) == {"pose_dispatch", "pose", "loop_zhang_host", "dense"}
    assert piped[0].pose_ok.tolist() == [True, False]


def test_mesh_must_split_the_batch():
    scene, flat = _pairs()
    pairs = [StereoPair(**scene), StereoPair(**flat), StereoPair(**flat)]
    with pytest.raises(ValueError, match="batch of 3 does not split into data=2"):
        tpb.run_batch(pairs, CONFIG, mesh=_mesh())
    with pytest.raises(ValueError, match="batch of 3 does not split into data=2"):
        tpb.run_batches([pairs[:2], pairs], CONFIG, mesh=_mesh())


def test_process_group_mesh_is_refused(tmp_path):
    import torch.distributed as dist

    from stereo_reconstruction_tpu_torch.parallel import multihost

    scene, _ = _pairs()
    multihost.initialize("file://" + str(tmp_path / "store"), 1, 0, backend="gloo")
    try:
        mesh = multihost.global_mesh()
        with pytest.raises(NotImplementedError, match="every pair's F"):
            tpb.run_batch([StereoPair(**scene)], CONFIG, mesh=mesh)
        with pytest.raises(NotImplementedError, match="multi-process mesh"):
            tpb.run_batches([[StereoPair(**scene)]], CONFIG, mesh=mesh)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=[5, 10])
def wrong_pose(request):
    """[flat, scene] under JAX key ``request.param``, unsharded and on a
    data=2 mesh, in JAX and in the port on the same draws."""
    scene, flat = _pairs()
    key = jax.random.key(request.param)
    jax_pairs = [JaxStereoPair(**flat), JaxStereoPair(**scene)]
    jax_runs = [jpb.run_batch(jax_pairs, JAX_CONFIG, key=key),
                jpb.run_batch(jax_pairs, JAX_CONFIG, key=key,
                              mesh=jax_make_mesh(data=2, tile=1, devices=jax.devices()[:2]))]
    pairs = [StereoPair(**flat), StereoPair(**scene)]
    u = torch.from_numpy(jax_batch_uniforms(JAX_CONFIG, 2, key))
    port_runs = [tpb.run_batch(pairs, CONFIG, uniforms=u, device="cpu"),
                 tpb.run_batch(pairs, CONFIG, uniforms=u, mesh=_mesh())]
    return jax_runs, port_runs


def _agreement(runs, i):
    return np.mean(np.asarray(runs[0].disparity)[i] == np.asarray(runs[1].disparity)[i])


def test_mesh_wrong_pose_moves_no_more_than_jax(wrong_pose):
    jax_runs, port_runs = wrong_pose
    for res in jax_runs + port_runs:
        assert np.asarray(res.pose_ok).tolist() == [False, True]
    for res in jax_runs:
        assert res.metrics[1]["bad_percent"] > 20.0          # JAX's scene pose is wrong
    for res in port_runs:
        assert res.metrics[1]["bad_percent"] < 15.0          # the port's, settled, is right
    for want, got in zip(jax_runs, port_runs):
        agree = np.mean(got.disparity[0] == np.asarray(want.disparity)[0])
        assert agree >= AGREEMENT, f"flat pair: agreement {agree:.5f} with JAX"
    jax_agree, port_agree = _agreement(jax_runs, 1), _agreement(port_runs, 1)
    assert jax_agree < 0.995, f"JAX holds the gate here ({jax_agree:.5f})"
    assert port_agree >= 0.995, f"port {port_agree:.5f} below the gate"
    # the failed pair's BA error moves with B by more than the 1% gate in JAX
    err = [[r.metrics[0]["reproj_error_ba"] for r in runs] for runs in (jax_runs, port_runs)]
    assert abs(err[0][0] - err[0][1]) > 0.01, err
    assert max(err[0] + err[1]) <= 0.05, err


def test_mesh_wrong_pose_under_the_ports_own_draws():
    scene, flat = _pairs()
    pairs = [StereoPair(**flat), StereoPair(**scene)]
    u = tpb.batch_uniforms(CONFIG, 2)
    runs = [tpb.run_batch(pairs, CONFIG, uniforms=u, device="cpu"),
            tpb.run_batch(pairs, CONFIG, uniforms=u, mesh=_mesh())]
    for res in runs:
        assert res.pose_ok.tolist() == [False, True]
        assert res.metrics[1]["bad_percent"] < 15.0      # right once BA has settled
    np.testing.assert_array_equal(runs[0].disparity[0], runs[1].disparity[0])
    agree = _agreement(runs, 1)
    assert agree >= 0.995, f"scene: agreement {agree:.5f} between B = 2 and B = 1"
