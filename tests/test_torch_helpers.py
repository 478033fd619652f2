"""The port's small public helpers against the JAX package's on the CPU.

* ``ops/geometry.py``: ``to_homogeneous`` / ``from_homogeneous`` (the
  round trip of ``tests/test_geometry.py``, batched over leading
  dimensions too) and ``average_reconstruction_error`` (below 1e-4 on the
  perfect scene of ``tests/test_geometry.py``; on a noisy batch), each
  equal to JAX's within 1e-5.
* ``pose/eight_point.py``: ``reprojection_errors`` and
  ``fundamental_matrix`` on one ``eight_point`` result within 1e-5 of
  JAX's, and on each package's own result for the same matches (exact and
  with 0.5 px of noise): R and F within the pose tolerance of
  ``tests/test_torch_pose.py`` (1e-3), the reprojection errors within 5e-3
  of max(1 px, the error), the reprojection tolerance of
  ``tests/test_torch_batch.py`` (measured: 1.5e-3 px noise-free; 0.25% of
  errors of 1-5 px with noise, whose triangulated depths move with the
  float32 eight-point solve).
* ``stereo_reconstruction_tpu_torch.rectify`` exports exactly the names of
  JAX's ``rectify/__init__.py``, each the port's own object.
"""

import ast
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu import pose as jpose
from stereo_reconstruction_tpu.ops import geometry as jg
from stereo_reconstruction_tpu_torch import pose as tpose
from stereo_reconstruction_tpu_torch import rectify as trectify
from stereo_reconstruction_tpu_torch.ops import geometry as tg

from test_pose import _synthetic_scene

torch.set_num_threads(1)

# the packages' ``pose.eight_point`` names the function; these are the modules
jep = importlib.import_module("stereo_reconstruction_tpu.pose.eight_point")
tep = importlib.import_module("stereo_reconstruction_tpu_torch.pose.eight_point")

TOL = 1e-5
POSE_TOL = 1e-3
REPROJ_TOL = 5e-3          # px, and relative above 1 px
REPO = os.path.join(os.path.dirname(__file__), "..")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    diff = np.abs(got.numpy().astype(np.float64) - want)
    assert diff.max() <= tol * max(1.0, float(np.abs(want).max())), diff.max()


@pytest.mark.parametrize("batch", [(), (4,), (2, 3)])
def test_homogeneous_roundtrip(rng, batch):
    pts = rng.standard_normal(batch + (2, 7)).astype(np.float32)
    h = tg.to_homogeneous(_t(pts))
    assert h.shape == batch + (3, 7) and h.dtype == torch.float32
    _close(h, jg.to_homogeneous(jnp.asarray(pts)))
    np.testing.assert_allclose(tg.from_homogeneous(h).numpy(), pts, atol=1e-6)
    # a third row other than 1 is divided out as JAX does
    p3 = rng.uniform(0.5, 2.0, batch + (3, 7)).astype(np.float32)
    _close(tg.from_homogeneous(_t(p3)), jg.from_homogeneous(jnp.asarray(p3)))


def _perfect_scene():
    """``tests/test_geometry.py::test_average_reconstruction_error_zero_for_perfect``
    (reference test_bundle_adjustment.cpp:49-50)."""
    K = np.eye(3, dtype=np.float32)
    ml = np.array([[0, 0, 0, 250, 250, 250, 500, 500, 500],
                   [0, 250, 500, 0, 250, 500, 0, 250, 500],
                   [1, 1, 1, 1, 1, 1, 1, 1, 1]], np.float32)
    depth = np.array([10, 10, 10, 20, 20, 20, 30, 30, 30], np.float32)
    pts3d = ml * depth[None, :]
    a = 50 * np.pi / 180
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                 np.float32)
    T = np.array([0.0, 0.0, 10.0], np.float32)
    mr = np.asarray(jg.project(jnp.asarray(K), jg.transform(jnp.asarray(R), jnp.asarray(T),
                                                            jnp.asarray(pts3d))))
    return ml, mr, K, K, R, T, pts3d


def test_average_reconstruction_error_zero_for_perfect():
    args = _perfect_scene()
    got = tg.average_reconstruction_error(*map(_t, args))
    want = jg.average_reconstruction_error(*map(jnp.asarray, args))
    assert got.shape == () and float(got) < 1e-4
    _close(got, want)


def test_average_reconstruction_error_batched_with_noise(rng):
    ml, mr, K, _, R, T, pts3d = _perfect_scene()
    noise = rng.normal(0, 2.0, (3, 2, ml.shape[1])).astype(np.float32)
    ml_b = np.stack([ml] * 3)
    ml_b[:, :2] += noise
    mr_b = np.stack([mr] * 3)
    mr_b[:, :2] -= noise[::-1]
    args = (ml_b, mr_b, K, K, R, T, pts3d)
    got = tg.average_reconstruction_error(*map(_t, args))
    want = jg.average_reconstruction_error(*map(jnp.asarray, args))
    assert got.shape == (3,) and float(got.min()) > 0.5
    _close(got, want)


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_reprojection_errors_and_fundamental_matrix(rng, noise):
    kp_l, kp_r, K, _, _ = _synthetic_scene(rng, n=30, outlier_frac=0.0)
    kp_r[:2] += rng.normal(0, noise, kp_r[:2].shape).astype(np.float32)
    j = jpose.eight_point(jnp.asarray(kp_l), jnp.asarray(kp_r), jnp.asarray(K),
                          jnp.asarray(K))
    t = tpose.eight_point(_t(kp_l), _t(kp_r), _t(K), _t(K))
    assert bool(j.valid) and bool(t.valid)

    # the functions themselves, on JAX's result carried across
    carried = tep.EightPointResult(*(_t(np.asarray(x)) for x in j))
    err = tep.reprojection_errors(carried, _t(kp_r), _t(K))
    assert err.shape == (30,)
    _close(err, jep.reprojection_errors(j, jnp.asarray(kp_r), jnp.asarray(K)))
    F = tep.fundamental_matrix(carried, _t(K), _t(K))
    F_j = jep.fundamental_matrix(j, jnp.asarray(K), jnp.asarray(K))
    _close(F, F_j)

    # each package's own result for the same matches
    err_t = tep.reprojection_errors(t, _t(kp_r), _t(K))
    err_j = np.asarray(jep.reprojection_errors(j, jnp.asarray(kp_r), jnp.asarray(K)))
    assert np.all(np.abs(err_t.numpy() - err_j) <= REPROJ_TOL * np.maximum(1.0, err_j))
    _close(t.rotation, j.rotation, POSE_TOL)
    F_t = tep.fundamental_matrix(t, _t(K), _t(K))
    _close(F_t, F_j, POSE_TOL)
    assert abs(float(torch.linalg.matrix_norm(F_t)) - 1.0) < 1e-5
    if noise == 0.0:
        assert float(err_t.max()) < 1e-2            # exact matches reproject exactly


def test_fundamental_matrix_batched(rng):
    """A batch of results normalises each F on its own (JAX's callers vmap)."""
    kp_l, kp_r, K, _, _ = _synthetic_scene(rng, n=30, outlier_frac=0.0)
    scale = np.array([1.0, 3.0], np.float32)[:, None, None]
    res = tpose.eight_point(_t(kp_l).expand(2, 3, 30), _t(kp_r).expand(2, 3, 30),
                            _t(K), _t(K))
    res = res._replace(essential=res.essential * _t(scale))
    F = tep.fundamental_matrix(res, _t(K), _t(K))
    one = tep.fundamental_matrix(tpose.eight_point(_t(kp_l), _t(kp_r), _t(K), _t(K)),
                                 _t(K), _t(K))
    for i in range(2):
        _close(F[i], one.numpy())


def _exported(path):
    """The names an ``__init__.py`` imports from its submodules."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
            for a in node.names}


def test_rectify_exports_jax_names():
    want = _exported(os.path.join(REPO, "stereo_reconstruction_tpu", "rectify", "__init__.py"))
    assert len(want) == 9
    assert _exported(trectify.__file__) == want
    for name in want:
        obj = getattr(trectify, name)
        assert obj.__module__.startswith("stereo_reconstruction_tpu_torch.rectify."), name
        assert getattr(importlib.import_module(obj.__module__), name) is obj
