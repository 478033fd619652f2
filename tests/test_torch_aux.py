"""The port's auxiliary modules against the JAX package on the CPU:
``recon/simple_mesh.py`` (outputs and OFF bytes equal), ``recon/
disparity.py::scale_disparity`` (bit for bit), ``utils/debug.py`` (the
cases of ``tests/test_debug_guards.py``) and ``utils/roofline.py`` (hand
values and PERF.md's bound column for the NVIDIA H100)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu.recon import disparity as jdisp
from stereo_reconstruction_tpu.recon.simple_mesh import SimpleMesh as JMesh
from stereo_reconstruction_tpu.recon.simple_mesh import show_extrinsics as jshow
from stereo_reconstruction_tpu_torch import recon as trecon
from stereo_reconstruction_tpu_torch.recon.simple_mesh import SimpleMesh as TMesh
from stereo_reconstruction_tpu_torch.recon.simple_mesh import show_extrinsics as tshow
from stereo_reconstruction_tpu_torch.utils import debug, roofline

torch.set_num_threads(1)


def _assert_mesh_equal(got, want):
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.colors, want.colors)
    np.testing.assert_array_equal(got.triangles, want.triangles)
    assert got.positions.dtype == want.positions.dtype
    assert got.triangles.dtype == want.triangles.dtype


def _pose(rng):
    a = rng.normal(size=3) * 0.3
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    P = np.eye(4)
    P[:3, :3] = np.eye(3) + K + K @ K / 2
    P[:3, 3] = rng.normal(size=3)
    return P


@pytest.mark.parametrize("build", [
    lambda M, rng: M.sphere([1.0, 2.0, 3.0], scale=0.5),
    lambda M, rng: M.sphere(rng.normal(size=3), 2.0, (9, 8, 7, 6), stacks=4, slices=5),
    lambda M, rng: M.cylinder([0.0, 0.0, 1.0], [0.0, 3.0, 1.0], radius=0.25, stacks=3,
                              slices=12),
    lambda M, rng: M.cylinder([0.0, 0.0, 0.0], [0.0, 0.0, -2.0], 0.5),   # antiparallel axis
    lambda M, rng: M.camera(_pose(rng), scale=0.1),
    lambda M, rng: M.join(M.sphere([0.0, 0.0, 0.0], 1.0), M.camera(np.eye(4), 0.5),
                          pose1to2=_pose(rng)),
    lambda M, rng: M.sphere([0.0, 0.0, 0.0], 1.0).transform(_pose(rng)),
])
def test_simple_mesh_equals_jax(build, tmp_path):
    got = build(TMesh, np.random.default_rng(0))
    want = build(JMesh, np.random.default_rng(0))
    _assert_mesh_equal(got, want)
    got.write(str(tmp_path / "t.off"))
    want.write(str(tmp_path / "j.off"))
    assert (tmp_path / "t.off").read_bytes() == (tmp_path / "j.off").read_bytes()
    _assert_mesh_equal(TMesh.read(str(tmp_path / "t.off")),
                       JMesh.read(str(tmp_path / "j.off")))


def test_show_extrinsics_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(3, 5)) * 3
    pose = _pose(rng)
    got = tshow(str(tmp_path / "t.off"), pose, pts)
    want = jshow(str(tmp_path / "j.off"), pose, pts)
    _assert_mesh_equal(got, want)
    assert (tmp_path / "t.off").read_bytes() == (tmp_path / "j.off").read_bytes()
    assert TMesh.empty().num_vertices == 0 and TMesh.empty().num_triangles == 0


@pytest.mark.parametrize("dtype,factor", [(np.float32, 0.5), (np.float32, 1.7),
                                          (np.int16, 2.0), (np.uint8, 0.25)])
def test_scale_disparity_equals_jax(dtype, factor):
    rng = np.random.default_rng(2)
    d = (rng.uniform(-5, 200, (30, 40))).astype(dtype)
    want = np.asarray(jdisp.scale_disparity(jnp.asarray(d), factor))
    got = trecon.scale_disparity(torch.from_numpy(d), factor)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_guard_raises_under_checked():
    def f(x):
        debug.guard((x > 0).all(), "x must be positive")
        return torch.sqrt(x)

    safe = debug.checked(f)
    np.testing.assert_allclose(safe(torch.tensor([4.0])), [2.0])
    with pytest.raises(debug.CheckError, match="positive"):
        safe(torch.tensor([-1.0]))


def test_guard_is_noop_outside_checked():
    def f(x):
        debug.guard(torch.tensor(False), "never raises outside checked")
        debug.guard_finite(torch.tensor([float("nan")]), "never")
        return x * 2

    np.testing.assert_allclose(f(torch.tensor([3.0])), [6.0])
    # the switch is reset after a checked call, also after a failed one
    with pytest.raises(debug.CheckError):
        debug.checked(lambda: debug.guard(False, "fails {what}", what="here"))()
    f(torch.tensor([1.0]))


def test_guard_finite():
    def f(x):
        y = x - 1.0
        debug.guard_finite(y, "y")
        return y

    safe = debug.checked(f)
    safe(torch.ones(4))
    with pytest.raises(debug.CheckError, match="NaN/Inf"):
        safe(torch.tensor([float("inf"), 1.0, 2.0, 3.0]))


def test_full_checks_catch_nan_production():
    def f(x):
        return torch.log(x)          # log(-1) -> NaN

    safe = debug.checked(f, errors=debug.FULL_CHECKS)
    safe(torch.tensor([1.0, 2.0]))
    with pytest.raises(debug.CheckError, match="nan"):
        safe(torch.tensor([-1.0]))
    # user checks alone let the NaN through, as JAX's USER_CHECKS do
    assert torch.isnan(debug.checked(f)(torch.tensor([-1.0]))).all()
    with pytest.raises(ValueError):
        debug.checked(f, errors="index")


def test_roofline_hand_values():
    # 1 GB over 3.35 TB/s; 1 TFLOP over 67 TFLOP/s
    assert roofline.bound(1e9, 1.0) == (pytest.approx(1e9 / 3.35e12 * 1e3), "bytes")
    assert roofline.bound(1.0, 1e12) == (pytest.approx(1e12 / 67e12 * 1e3), "operations")
    # a 4x4 image, block 3 (hbs 1), D=2: reach = min(3, x + 1) = 1, 2, 3, 3, so
    # pixels with a candidate per row: clip(4 - reach, 0, 2) = 2, 2, 1, 1
    s = dict(h=4, w=4, wl_extra=0, bs=3, min_d=0, max_d=2)
    nbytes, ops = roofline.matcher_bytes_ops(s, out_planes=5)
    assert nbytes == 4 * 3 * 4 * 8 + 4 * 5 * 16
    assert ops == 4 * 6 * (9 + 4 + 3)
    assert roofline.scan_bytes_ops(3, 5) == (25 * 15, 30 * 15)


def test_roofline_matches_the_kernel_table():
    """PERF.md §6's bound column (printed by chip_smoke.py): K1 and K2 at
    (b) 1128x1408, D=200, block 17; K1b at (b); K4 at 375x450, D=100."""
    b = dict(h=1128, w=1408, wl_extra=0, bs=17, min_d=0, max_d=200)
    k1 = roofline.matcher_bound(b, out_planes=5)
    k2 = roofline.matcher_bound(b, out_planes=200)
    k1b = roofline.scan_bound(1128, 1408)
    k4 = roofline.window_scan_bound(375, 100, 450)
    assert (round(k1[0], 4), k1[1]) == (0.1927, "operations")
    assert (round(k2[0], 4), k2[1]) == (0.3907, "bytes")
    assert (round(k1b[0], 4), k1b[1]) == (0.0119, "bytes")
    assert (round(k4[0], 4), k4[1]) == (0.0204, "bytes")
    r = roofline.report(1.58 + 2.41, 1128, 1408, 200)
    assert r["kernels_ms"] == {"K1": k1[0], "K1b": k1b[0]}
    assert r["binding_resource"] == "operations"
    assert r["gap_to_binding_bound"] == pytest.approx(3.99 / r["floor_ms_binding"])
    assert r["floor_ms_binding"] > k1[0]
