"""The port's multi-device layer against the JAX package on the CPU.

The JAX side runs on the eight host devices that ``tests/conftest.py``
forces (``make_mesh(data=2, tile=4)``); the port's one-process mesh runs
its eight shards in turn on ``["cpu"] * 8``. The same numpy inputs, made
from a seed, go through both:

* the global-row volume (``cost_volume_right_ssd(row_offset=,
  total_height=)``) and K1's planes in global mode (the wrapper takes its
  plain twin on the CPU) against JAX's XLA volume and its Pallas kernel in
  interpret mode, on halo-extended tiles with ``min_d`` 0 and > 0: bit for
  bit (integer-valued images: exact window sums), on every row;
* the seeded row scan (``first_flags``, ``init_prev``) against JAX's: bit
  for bit;
* ``sharded_block_search_right``, both modes and both backends, at
  ``tests/test_sharding.py``'s shapes: bit for bit against JAX's sharded
  output and the port's single-device matcher;
* ``sharded_evaldisp`` within JAX's tolerances (bad% atol 0.05, avg err
  rtol 1e-3) and the distributed and multi-view BAs within
  ``tests/test_sharding.py`` / ``tests/test_ba_multiview.py``'s (the
  multi-view translations and points up to the scale gauge,
  ``torch_helpers.scale_aligned``, its factor within 5e-3 of 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu import parallel as jpar
from stereo_reconstruction_tpu.config import BundleAdjustmentConfig as JBAConfig
from stereo_reconstruction_tpu.config import MatcherConfig as JMatcherConfig
from stereo_reconstruction_tpu.ops import cost_volume as jcv
from stereo_reconstruction_tpu.ops import geometry as jgeo
from stereo_reconstruction_tpu.ops import smoothing as jsm
from stereo_reconstruction_tpu.ops.pallas_cost_volume import pallas_matcher_inputs
from stereo_reconstruction_tpu.parallel import ba_multiview as jmv
from stereo_reconstruction_tpu_torch import parallel as tpar
from stereo_reconstruction_tpu_torch.config import BundleAdjustmentConfig, MatcherConfig
from stereo_reconstruction_tpu_torch.ops import cuda_cost_volume as ccv
from stereo_reconstruction_tpu_torch.ops import cuda_row_scan as crs
from stereo_reconstruction_tpu_torch.ops import smoothing as tsm
from stereo_reconstruction_tpu_torch.ops.block_search import block_search_right
from stereo_reconstruction_tpu_torch.ops.metrics import evaldisp
from stereo_reconstruction_tpu_torch.parallel import ba_multiview as tmv
from stereo_reconstruction_tpu_torch.pose.ba import bundle_adjust

from test_ba_multiview import _pose_errors, _synthetic_sequence
from test_block_search import _random_stereo
from test_sharding import _pair_batch
from torch_helpers import halo_tile, scale_aligned, scan_volume

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh(data=2, tile=4)


@pytest.fixture(scope="module")
def tmesh():
    return tpar.make_mesh(data=2, tile=4, devices=["cpu"] * 8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tile(img, row0, n):
    """``torch_helpers.halo_tile`` of a numpy image, as float32 numpy."""
    return halo_tile(torch.from_numpy(img).float(), row0, n).numpy()


# (rows of the whole image, local row 0, tile rows, min_d, max_d, block)
TILES = [
    (40, -6, 20, 0, 10, 7),     # the top tile: 6 rows of padding above the image
    (40, 9, 20, 2, 12, 7),      # an inner tile, min_d > 0
    (40, 26, 20, 0, 10, 5),     # the bottom tile: padding below the image
]


@pytest.mark.parametrize("h,row0,n,min_d,max_d,bs", TILES)
def test_global_row_volume_equals_jax(h, row0, n, min_d, max_d, bs):
    rng = np.random.default_rng(h + row0)
    left, right = _random_stereo(rng, h=h, w=36, max_d=8)
    lt, rt = _tile(left, row0, n), _tile(right, row0, n)
    want = np.asarray(jcv.cost_volume_right_ssd(
        jnp.asarray(lt), jnp.asarray(rt), bs, min_d, max_d,
        row_offset=jnp.int32(row0), total_height=jnp.int32(h)))
    got = ccv.cost_volume(_t(lt), _t(rt), bs, min_d, max_d, row_offset=row0,
                          total_height=h).numpy()
    np.testing.assert_array_equal(got, want)
    # the rows whose window support the tile holds equal the whole image's
    hw = bs - 1
    whole = ccv.cost_volume(_t(left).float(), _t(right).float(), bs, min_d, max_d).numpy()
    lo, hi = max(row0 + hw, 0), min(row0 + n - hw, h)
    np.testing.assert_array_equal(got[:, lo - row0:hi - row0], whole[:, lo:hi])


@pytest.mark.parametrize("h,row0,n,min_d,max_d,bs", TILES)
def test_global_row_planes_equal_jax_pallas(h, row0, n, min_d, max_d, bs):
    rng = np.random.default_rng(h + row0)
    left, right = _random_stereo(rng, h=h, w=36, max_d=8)
    lt, rt = _tile(left, row0, n), _tile(right, row0, n)
    want = pallas_matcher_inputs(jnp.asarray(lt), jnp.asarray(rt), bs, min_d, max_d,
                                 interpret=True, row_offset=row0, total_height=h)
    got = ccv.matcher_inputs(_t(lt), _t(rt), bs, min_d, max_d, row_offset=row0,
                             total_height=h)
    hw = bs - 1
    kept = slice(hw, n - hw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[kept], np.asarray(w)[kept])


@pytest.mark.parametrize("w,d_first", [(33, 0), (70, 2)])
def test_seeded_scan_equals_jax(w, d_first):
    rng = np.random.default_rng(w)
    D, h = 12, 9
    cost, black = scan_volume(rng, h, w, D)
    first = rng.random(h) < 0.3
    first[0] = False
    xs = np.arange(w, dtype=np.float32)
    # the seed row: zeros, sentinels -x and ordinary disparities
    init = np.choose(rng.integers(0, 3, w), [np.zeros(w, np.float32), -xs,
                                             rng.integers(0, D, w).astype(np.float32)])
    init = init.astype(np.float32)
    planes = jsm.volume_reductions(jnp.asarray(cost), d_first)
    want = np.asarray(jsm.smoothed_argmin_from_inputs(
        *planes, jnp.asarray(black), smooth_factor=0.9, d_first=d_first, n_planes=D,
        first_flags=jnp.asarray(first), init_prev=jnp.asarray(init)))
    tplanes = tsm.volume_reductions(_t(cost), d_first)
    got = crs.row_scan(*tplanes, _t(black), smooth_factor=0.9, d_first=d_first,
                       n_planes=D, first_flags=_t(first), init_prev=_t(init))
    np.testing.assert_array_equal(got.numpy(), want)
    # and without them, row 0 alone is first and the seed is ignored there
    plain = crs.row_scan(*tplanes, _t(black), smooth_factor=0.9, d_first=d_first,
                         n_planes=D)
    seeded_first = crs.row_scan(*tplanes, _t(black), smooth_factor=0.9,
                                d_first=d_first, n_planes=D, init_prev=_t(init))
    assert torch.equal(plain, seeded_first)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_matcher_equals_jax(rng, jmesh, tmesh, backend, exact):
    shape = dict(b=2, h=96, w=96) if exact else {}
    left, right = (np.asarray(a) for a in _pair_batch(rng, **shape))
    kw = dict(block_size=5, min_disparity=0, max_disparity=16, row_smooth_iters=1)
    want = np.asarray(jpar.sharded_block_search_right(
        jnp.asarray(left), jnp.asarray(right), jmesh, JMatcherConfig(backend=backend, **kw),
        exact=exact))
    got = tpar.sharded_block_search_right(_t(left), _t(right), tmesh,
                                          MatcherConfig(backend=backend, **kw), exact=exact)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    single = torch.stack([block_search_right(_t(left[i]), _t(right[i]),
                                             MatcherConfig(backend="xla", **kw))
                          for i in range(left.shape[0])])
    assert torch.equal(got, single)


def test_sharded_matcher_warmup_cut_and_refusals(tmesh):
    """A short warm-up cuts the chain (rows may differ, as in JAX), and the
    mesh refuses what it cannot split."""
    rng = np.random.default_rng(1)
    left, right = (_t(np.asarray(a)) for a in _pair_batch(rng, b=2, h=64, w=96))
    cfg = MatcherConfig(block_size=5, max_disparity=16, backend="xla")
    got = tpar.sharded_block_search_right(left, right, tmesh, cfg, warmup=0)
    single = torch.stack([block_search_right(left[i], right[i], cfg) for i in range(2)])
    assert got.shape == single.shape and (got == single).float().mean() > 0.9
    with pytest.raises(ValueError, match="row tiles"):
        tpar.sharded_block_search_right(left[:, :62], right[:, :62], tmesh, cfg)
    with pytest.raises(ValueError, match="data"):
        tpar.sharded_block_search_right(left[:1], right[:1], tmesh, cfg)
    with pytest.raises(ValueError, match="devices"):
        tpar.make_mesh(data=3, tile=3, devices=["cpu"] * 8)
    assert tpar.make_mesh(data=2, devices=["cpu"] * 8).shape == {"data": 2, "tile": 4}


def test_sharded_evaldisp_equals_jax(rng, jmesh, tmesh):
    b, h, w = 4, 64, 96
    disp = rng.uniform(0, 20, (b, h, w)).astype(np.float32)
    gt = rng.uniform(0, 20, (b, h, w)).astype(np.float32)
    gt[0, :3] = np.inf
    mask = np.where(rng.random((b, h, w)) < 0.8, 255, 0).astype(np.uint8)
    want = jpar.sharded_evaldisp(jnp.asarray(disp), jnp.asarray(gt), jnp.asarray(mask),
                                 jmesh, bad_thresh=2.0, max_disp=32.0)
    got = tpar.sharded_evaldisp(_t(disp), _t(gt), _t(mask), tmesh, bad_thresh=2.0,
                                max_disp=32.0)
    for k in ("bad_percent", "invalid_percent", "total_bad_percent"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=0.05)
    np.testing.assert_allclose(float(got["avg_err"]), float(want["avg_err"]), rtol=1e-3)
    # and the single-device metric of the whole batch as one image
    one = evaldisp(_t(disp.reshape(b * h, w)), _t(gt.reshape(b * h, w)),
                   _t(mask.reshape(b * h, w)), bad_thresh=2.0, max_disp=32.0)
    np.testing.assert_allclose(float(got["bad_percent"]), float(one["bad_percent"]),
                               atol=0.05)
    np.testing.assert_allclose(float(got["avg_err"]), float(one["avg_err"]), rtol=1e-3)


def _two_view(rng, i=0, n_pts=64):
    """tests/test_sharding.py's BA problem (pair ``i`` of its batch)."""
    K = jnp.array([[500.0, 0, 160], [0, 500.0, 120], [0, 0, 1]])
    aa = jnp.array([0.03, -0.05, 0.02]) * (1.0 + 0.3 * i)
    R = jgeo.angle_axis_to_rotation(aa)
    T = jnp.array([-0.6, 0.05, 0.2]) + 0.1 * i
    depths = jnp.asarray(rng.uniform(4, 9, n_pts).astype(np.float32))
    xl = jnp.concatenate([jnp.asarray(rng.uniform(-0.25, 0.25, (2, n_pts)).astype(np.float32)),
                          jnp.ones((1, n_pts))])
    pts = xl * depths[None, :]
    args = (jgeo.project(K, pts), jgeo.project(K, jgeo.transform(R, T, pts)), K, K,
            jgeo.angle_axis_to_rotation(aa + 0.03), T + 0.05, pts)
    return tuple(np.asarray(a, np.float32) for a in args)


def test_distributed_ba_equals_jax(rng, jmesh, tmesh):
    args = _two_view(rng)
    jres = jpar.distributed_bundle_adjust(*map(jnp.asarray, args), jmesh,
                                          config=JBAConfig(max_iterations=10))
    cfg = BundleAdjustmentConfig(max_iterations=10)
    tres = tpar.distributed_bundle_adjust(*map(_t, args), tmesh, config=cfg)
    single = bundle_adjust(*map(_t, args), config=cfg)
    for other in (jres, single):
        np.testing.assert_allclose(tres.rotation.numpy(), np.asarray(other.rotation),
                                   atol=1e-3)
        np.testing.assert_allclose(tres.translation.numpy(), np.asarray(other.translation),
                                   atol=5e-3)
        np.testing.assert_allclose(float(tres.final_cost), float(other.final_cost),
                                   rtol=0.05, atol=1e-3)
    assert tres.points.shape == (3, 64)
    assert float(tres.final_cost) < 0.1 * float(tres.initial_cost)


def test_distributed_ba_batch_equals_jax(rng, jmesh, tmesh):
    B = 3
    probs = [_two_view(rng, i) for i in range(B)]
    stacked = [np.stack([p[k] for p in probs]) for k in range(7)]
    kl, kr, K, _, R0, T0, pts = stacked
    jposes, _, _, jcf, _ = jpar.distributed_bundle_adjust_batch(
        jnp.asarray(kl), jnp.asarray(kr), jnp.asarray(K[0]), jnp.asarray(K[0]),
        jnp.asarray(R0), jnp.asarray(T0), jnp.asarray(pts), jmesh,
        config=JBAConfig(max_iterations=8))
    cfg = BundleAdjustmentConfig(max_iterations=8)
    poses, F, c0, cf, X = tpar.distributed_bundle_adjust_batch(
        _t(kl), _t(kr), _t(K[0]), _t(K[0]), _t(R0), _t(T0), _t(pts), tmesh, config=cfg)
    assert poses.shape == (B, 4, 4) and F.shape == (B, 3, 3) and X.shape == (B, 3, 64)
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=2e-3)
    np.testing.assert_allclose(cf.numpy(), np.asarray(jcf), rtol=0.05, atol=1e-4)
    for i in range(B):
        res_i = tpar.distributed_bundle_adjust(*map(_t, probs[i]), tmesh, config=cfg)
        np.testing.assert_allclose(poses[i].numpy(), res_i.pose.numpy(), atol=2e-3)
        np.testing.assert_allclose(float(cf[i]), float(res_i.final_cost), rtol=0.05,
                                   atol=1e-4)
        assert float(cf[i]) < 0.05 * float(c0[i])


@pytest.mark.parametrize("devices", [["cpu"] * 2, ["meta"] * 2])
def test_mesh_refuses_a_tensor_off_its_device_kind(devices):
    """A shard takes its block on its own kind of device and no other: a
    tensor of another kind raises, never is copied over (a card tensor is
    never moved to a host shard); tensors of the mesh's kind pass."""
    mesh = tpar.make_mesh(data=1, tile=2, devices=devices)
    x = torch.zeros(4, 3)

    async def body(shard, blk):
        return blk

    if devices[0] == "cpu":
        assert torch.equal(tpar.mesh.shard_map(body, mesh, [("tile",)], ("tile",), x), x)
        x = x.to("meta")
    with pytest.raises(ValueError, match="put the inputs on the mesh's devices"):
        tpar.mesh.shard_map(body, mesh, [("tile",)], ("tile",), x)


def test_multiview_ba_equals_jax(rng):
    """The port's single-device and distributed solves against JAX's and
    against each other at ``tests/test_ba_multiview.py``'s tolerances
    (poses 2e-3, points 5e-3): rotations as they are, translations and
    points up to the scale gauge (``torch_helpers.scale_aligned``). Only
    camera 0 is pinned, so the problem's scale is a gauge freedom: the
    damped solve amplifies rounding along it (by 1 / lambda), and two sums
    of the same terms in another order end at scales ~0.1% apart (JAX's
    own single and distributed solves 0.0044 apart in points, the port's
    0.011; after the alignment they agree to ~2e-5)."""
    K, poses_gt, X_gt, obs = _synthetic_sequence(rng, M=4, n_grid=8)
    M, N = obs.shape[:2]
    X0 = X_gt + rng.normal(0, 0.1, X_gt.shape)
    poses0 = poses_gt.copy()
    poses0[1:, 3:] += rng.normal(0, 0.05, (M - 1, 3))
    args = [a.astype(np.float32) for a in (obs, np.stack([K] * M), poses0, X0)]
    jcfg = JBAConfig(loss="l2", max_iterations=15)
    jsingle = jmv.multiview_bundle_adjust(*map(jnp.asarray, args), config=jcfg)
    jdist = jmv.distributed_multiview_bundle_adjust(*map(jnp.asarray, args),
                                                    mesh=jpar.make_mesh(data=4, tile=2),
                                                    config=jcfg)
    cfg = BundleAdjustmentConfig(loss="l2", max_iterations=15)
    single = tmv.multiview_bundle_adjust(*map(_t, args), config=cfg)
    mesh = tpar.make_mesh(data=4, tile=2, devices=["cpu"] * 8)
    dist = tmv.distributed_multiview_bundle_adjust(*map(_t, args), mesh=mesh, config=cfg)
    for got, want in ((single, jsingle), (dist, jdist), (dist, single)):
        poses, points, scale = scale_aligned(np.asarray(got.poses), np.asarray(got.points),
                                             np.asarray(want.points))
        assert abs(scale - 1) <= 5e-3
        np.testing.assert_allclose(poses, np.asarray(want.poses), atol=2e-3)
        np.testing.assert_allclose(points, np.asarray(want.points), atol=5e-3)
        np.testing.assert_allclose(got.poses[:, :3].numpy(), np.asarray(want.poses)[:, :3],
                                   atol=2e-3)
    for res in (single, dist):
        assert float(res.final_cost) < float(res.initial_cost) * 1e-3
        rot_err, t_err = _pose_errors(res.poses.numpy(), poses_gt)
        assert rot_err.max() < 0.1 and t_err.max() < 0.02
        np.testing.assert_allclose(res.poses[0].numpy(), 0.0, atol=1e-7)
    np.testing.assert_allclose(dist.pose_matrices.numpy(),
                               np.asarray(jdist.pose_matrices), atol=2e-3)
    fused = tmv.fuse_point_cloud(dist.points, mesh)
    np.testing.assert_allclose(fused.numpy(), dist.points.numpy(), rtol=1e-6)
