"""The port's process-group mesh: two CPU processes joined by
``torch.distributed`` (gloo, a ``file://`` store under ``tmp_path``), as
``tests/test_multihost.py`` gates the JAX package's two processes.

Each process runs ``WORKER``: ``multihost.initialize``, a ``global_mesh``
of ``data=1, tile=2`` (one row tile per process), the exact sharded
matcher and the distributed BA on the same seeded inputs, and the helpers
``from_local_shards`` / ``replicate`` / ``gather``; rank 0 saves the
results. They must equal the one-process mesh's (two shards in turn on
``["cpu"] * 2``): the matcher bit for bit (its halos and wavefront
seeds sent point to point), the BA's psum within
``tests/test_sharding.py``'s tolerances (rotation 1e-3, translation 5e-3,
cost rtol 0.05). Every subprocess has a timeout.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu_torch.config import BundleAdjustmentConfig, MatcherConfig
from stereo_reconstruction_tpu_torch.parallel import (
    distributed_bundle_adjust,
    make_mesh,
    sharded_block_search_right,
)

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(__file__), "..")
CFG = dict(block_size=5, max_disparity=16, backend="xla")
BA_CFG = dict(max_iterations=10)


def inputs():
    """The matcher's pair batch and the BA problem, from seed 0."""
    rng = np.random.default_rng(0)
    left = rng.integers(1, 255, (2, 48, 64, 3)).astype(np.uint8)
    right = np.roll(left, -6, axis=2)
    right[:, :, :2] = 0
    n = 32
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(4, 9, n)])
    K = np.array([[500.0, 0, 160], [0, 500.0, 120], [0, 0, 1]])
    th = 0.05
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    T = np.array([-0.6, 0.05, 0.2])
    proj = lambda P: (K @ P) / (K @ P)[2]          # noqa: E731
    R0 = np.array([[1.0, 0, 0.0], [0, 1, 0], [0.0, 0, 1]])
    ba = [proj(X), proj(R @ X + T[:, None]), K, K, R0, T + 0.05, X]
    return left, right, [a.astype(np.float32) for a in ba]


WORKER = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {tests!r})
from test_torch_multihost import BA_CFG, CFG, inputs
from stereo_reconstruction_tpu_torch.config import BundleAdjustmentConfig, MatcherConfig
from stereo_reconstruction_tpu_torch.parallel import (
    distributed_bundle_adjust, multihost, sharded_block_search_right)

rank = int(sys.argv[1])
multihost.initialize("file://" + sys.argv[2], 2, rank, backend="gloo")
mesh = multihost.global_mesh(data=1, tile=2)
left, right, ba = inputs()
# each process contributes its own row tile; the helper assembles the batch
rows = left.shape[1] // 2
lt = multihost.from_local_shards(torch.from_numpy(left[:, rank * rows:(rank + 1) * rows]),
                                 mesh, (None, "tile"))
assert torch.equal(lt, torch.from_numpy(left))
disp = sharded_block_search_right(lt, torch.from_numpy(right), mesh, MatcherConfig(**CFG),
                                  exact=True)
res = distributed_bundle_adjust(*map(torch.from_numpy, ba), mesh,
                                config=BundleAdjustmentConfig(**BA_CFG))
token = multihost.replicate(np.array([7.0 + rank]), mesh)
if rank == 0:
    np.savez(sys.argv[3], disp=multihost.gather(disp), R=multihost.gather(res.rotation),
             T=multihost.gather(res.translation), cost=multihost.gather(res.final_cost),
             c0=multihost.gather(res.initial_cost), token=multihost.gather(token),
             coords=np.array([mesh.coords["data"], mesh.coords["tile"]]))
torch.distributed.destroy_process_group()
"""


def test_two_processes_equal_the_one_process_mesh(tmp_path):
    code = WORKER.format(tests=os.path.dirname(os.path.abspath(__file__)))
    store, out = str(tmp_path / "store"), str(tmp_path / "rank0.npz")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.abspath(REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), store, out], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    got = np.load(out)

    left, right, ba = inputs()
    mesh = make_mesh(data=1, tile=2, devices=["cpu"] * 2)
    want = sharded_block_search_right(torch.from_numpy(left), torch.from_numpy(right), mesh,
                                      MatcherConfig(**CFG), exact=True)
    np.testing.assert_array_equal(got["disp"], want.numpy())
    res = distributed_bundle_adjust(*map(torch.from_numpy, ba), mesh,
                                    config=BundleAdjustmentConfig(**BA_CFG))
    np.testing.assert_allclose(got["R"], res.rotation.numpy(), atol=1e-3)
    np.testing.assert_allclose(got["T"], res.translation.numpy(), atol=5e-3)
    np.testing.assert_allclose(float(got["cost"]), float(res.final_cost), rtol=0.05,
                               atol=1e-3)
    assert float(got["cost"]) < 0.1 * float(got["c0"])
    assert got["token"].tolist() == [7.0]          # rank 0's value on every process
    assert got["coords"].tolist() == [0, 0]


def test_world_of_one_equals_the_one_process_mesh(tmp_path):
    """A process group of one (the card smoke's NCCL case, here on gloo):
    the exact matcher, ``sharded_evaldisp`` and ``fuse_point_cloud`` on a
    1x1 ``global_mesh`` equal the one-process mesh's; a mesh larger than
    the world is refused."""
    import torch.distributed as dist

    from stereo_reconstruction_tpu_torch.parallel import multihost, sharded_evaldisp
    from stereo_reconstruction_tpu_torch.parallel.ba_multiview import fuse_point_cloud

    left, right, _ = inputs()
    left, right = torch.from_numpy(left), torch.from_numpy(right)
    one = make_mesh(data=2, tile=4, devices=["cpu"] * 8)
    want = sharded_block_search_right(left, right, one, MatcherConfig(**CFG), exact=True)
    multihost.initialize("file://" + str(tmp_path / "store"), 1, 0, backend="gloo")
    try:
        mesh = multihost.global_mesh()
        got = sharded_block_search_right(left, right, mesh, MatcherConfig(**CFG), exact=True)
        assert torch.equal(got, want)
        gt = want + 1.5
        mask = torch.full(want.shape, 255, dtype=torch.uint8)
        m1 = sharded_evaldisp(got, gt, mask, mesh)
        m8 = sharded_evaldisp(want, gt, mask, one)
        for k in m1:
            np.testing.assert_allclose(float(m1[k]), float(m8[k]), rtol=1e-6)
        pts = torch.arange(24.0).reshape(8, 3)
        assert torch.equal(fuse_point_cloud(pts, mesh), pts)
        with pytest.raises(ValueError, match="processes"):
            multihost.global_mesh(data=2, tile=1)
        # a gloo mesh's shard lies on the host: a tensor on another kind of
        # device is refused, never copied there
        with pytest.raises(ValueError, match="mesh shard on cpu"):
            sharded_block_search_right(left.to("meta"), right.to("meta"), mesh,
                                       MatcherConfig(**CFG), exact=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("axes,idx,want", [
    (("tile",), 0, 3), (("tile",), 2, 5),        # along this rank's row of shards
    (("data",), 0, 1), (("data",), 1, 4),        # along its column
    (("data", "tile"), 5, 5),                    # the flattened mesh: the rank itself
])
def test_ppermute_peers_are_global_ranks(axes, idx, want):
    """The point-to-point sends of a ``ppermute`` address the global rank
    of the shard at ``idx`` along ``axes`` (rank 4 of a data=2, tile=3
    mesh: coordinates (1, 1))."""
    from types import SimpleNamespace

    from stereo_reconstruction_tpu_torch.parallel.multihost import ProcessGroupMesh

    me = SimpleNamespace(coords=dict(data=1, tile=1), shape=dict(data=2, tile=3))
    assert ProcessGroupMesh._rank(me, axes, idx) == want
