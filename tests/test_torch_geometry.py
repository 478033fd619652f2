"""The port's ``ops/geometry.py`` and ``ops/small_linalg.py`` against the
JAX package's on seeded inputs, on the CPU, rtol 1e-5 (eigenvectors up
to sign).

XLA lowers the Jacobi rotation's 1/sqrt(1 + t^2) to an rsqrt that is not
correctly rounded (17% of uniform inputs in [1, 2) come out 1 ulp off on
an x86 CPU), so no port reproduces the JAX solvers bit for bit. They are
compared on well-separated spectra, where 1-ulp rotation differences
stay at rounding level in the output; the ill-conditioned cases are
measured in tests/test_torch_pose.py. The triangulation's secular
equation amplifies rounding by the conditioning of its root, so it is
held at rtol 1e-4 (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu.ops import geometry as jg
from stereo_reconstruction_tpu.ops import small_linalg as jl
from stereo_reconstruction_tpu_torch.ops import geometry as tg
from stereo_reconstruction_tpu_torch.ops import small_linalg as tl

torch.set_num_threads(1)

RTOL = 1e-5
ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _intrinsics(rng, batch=()):
    K = np.zeros(batch + (3, 3), np.float32)
    K[..., 0, 0] = rng.uniform(400, 900, batch)
    K[..., 1, 1] = rng.uniform(400, 900, batch)
    K[..., 0, 1] = rng.uniform(-2, 2, batch)
    K[..., 0, 2] = rng.uniform(200, 400, batch)
    K[..., 1, 2] = rng.uniform(150, 300, batch)
    K[..., 2, 2] = 1.0
    return K


def _rotations(rng, n):
    return rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)


def _spd(rng, n, size, spread=10.0):
    """Symmetric positive-definite batch with well-separated eigenvalues."""
    Q, _ = np.linalg.qr(rng.normal(size=(n, size, size)))
    w = np.linspace(1.0, spread, size) * rng.uniform(0.5, 2.0, (n, 1))
    return np.einsum("nij,nj,nkj->nik", Q, w, Q).astype(np.float32)


@pytest.mark.parametrize("name", ["skew", "kron"])
def test_elementary(rng, name):
    a = rng.normal(size=(5, 3)).astype(np.float32)
    b = rng.normal(size=(5, 4)).astype(np.float32)
    if name == "skew":
        _close(tg.skew(_t(a)), jg.skew(jnp.asarray(a)), 0, 0)
    else:
        _close(tg.kron_vec(_t(a), _t(b)), jg.kron_vec(jnp.asarray(a), jnp.asarray(b)), 0, 0)


def test_normalize_points(rng):
    K = _intrinsics(rng, (4,))
    pts = np.concatenate([rng.uniform(0, 640, (4, 2, 9)), np.ones((4, 1, 9))], 1)
    pts = pts.astype(np.float32)
    got = tg.normalize_points(_t(K), _t(pts))
    _close(got, jg.normalize_points(jnp.asarray(K), jnp.asarray(pts)))
    _close(got, np.linalg.solve(K.astype(np.float64), pts), rtol=1e-5, atol=1e-6)


def test_project_transform_and_pixel_error(rng):
    K = _intrinsics(rng)
    R = jg.angle_axis_to_rotation(jnp.asarray(_rotations(rng, 1)[0]))
    T = rng.normal(size=3).astype(np.float32)
    X = np.concatenate([rng.uniform(-3, 3, (2, 11)), rng.uniform(5, 15, (1, 11))])
    X = X.astype(np.float32)
    obs = rng.uniform(0, 640, (3, 11)).astype(np.float32)
    obs[2] = 1.0
    Rt = _t(R)
    _close(tg.project(_t(K), _t(X)), jg.project(jnp.asarray(K), jnp.asarray(X)))
    _close(tg.transform(Rt, _t(T), _t(X)), jg.transform(R, jnp.asarray(T), jnp.asarray(X)))
    proj = tg.project(_t(K), tg.transform(Rt, _t(T), _t(X)))
    _close(tg.pixel_error(proj, _t(obs)),
           jg.pixel_error(jg.project(jnp.asarray(K), jg.transform(R, jnp.asarray(T),
                                                                   jnp.asarray(X))),
                          jnp.asarray(obs)), atol=1e-4)


def test_essential_and_fundamental(rng):
    aa = _rotations(rng, 6)
    T = rng.normal(size=(6, 3)).astype(np.float32)
    Kl, Kr = _intrinsics(rng), _intrinsics(rng)
    R_j = jg.angle_axis_to_rotation(jnp.asarray(aa))
    E_j = jg.essential_from_pose(R_j, jnp.asarray(T))
    E_t = tg.essential_from_pose(_t(R_j), _t(T))
    _close(E_t, E_j)
    # per matrix, as the JAX callers vmap it (called on a batch, the JAX
    # function divides by the norm of the whole batch)
    want = jax.vmap(lambda E: jg.fundamental_from_essential(
        E, jnp.asarray(Kl), jnp.asarray(Kr)))(E_j)
    _close(tg.fundamental_from_essential(E_t, _t(Kl), _t(Kr)), want, atol=1e-7)


@pytest.mark.parametrize("scale", [1.0, 1e-7, 0.0])
def test_rodrigues_both_ways(rng, scale):
    """Large angles, the tiny-angle series branch, and zero."""
    aa = _rotations(rng, 8) * np.float32(scale)
    R_t = tg.angle_axis_to_rotation(_t(aa))
    R_j = jg.angle_axis_to_rotation(jnp.asarray(aa))
    _close(R_t, R_j)
    _close(tg.rotation_to_angle_axis(R_t), jg.rotation_to_angle_axis(R_j), atol=1e-6)


def test_triangulate_depths(rng):
    """The arrow-form joint depths on a noise-free two-view scene, batched
    over two poses."""
    aa = _rotations(rng, 2) * np.float32(0.2)
    R = np.asarray(jg.angle_axis_to_rotation(jnp.asarray(aa)))
    T = np.array([[-1.0, 0.1, 0.2], [0.8, -0.1, 0.3]], np.float32)
    xl = np.concatenate([rng.uniform(-0.4, 0.4, (2, 2, 20)), np.ones((2, 1, 20))], 1)
    X = xl * rng.uniform(4, 12, (2, 1, 20))
    Xr = R @ X + T[:, :, None]
    xr = (Xr / Xr[:, 2:3]).astype(np.float32)
    xl = xl.astype(np.float32)
    got = tg.triangulate_depths(_t(xl), _t(xr), _t(R), _t(T))
    want = jg.triangulate_depths(jnp.asarray(xl), jnp.asarray(xr), jnp.asarray(R),
                                 jnp.asarray(T))
    _close(got, want, rtol=1e-4, atol=1e-5)


def _eigvec_close(got, want):
    """Columns equal up to sign."""
    got, want = got.numpy(), np.asarray(want)
    sign = np.sign(np.sum(got * want, axis=-2, keepdims=True))
    np.testing.assert_allclose(got * sign, want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("size", [3, 9])
def test_jacobi_eigh(rng, size):
    A = _spd(rng, 16, size)
    w_t, V_t = tl.jacobi_eigh(_t(A))
    w_j, V_j = jl.jacobi_eigh(jnp.asarray(A))
    _close(w_t, w_j, atol=1e-5)
    _eigvec_close(V_t, V_j)
    _eigvec_close(tl.smallest_eigvec(_t(A))[..., None],
                  jl.smallest_eigvec(jnp.asarray(A))[..., None])


def test_svd3_for_essential(rng):
    E = rng.normal(size=(16, 3, 3)).astype(np.float32)
    U_t, Vt_t = tl.svd3_for_essential(_t(E))
    U_j, Vt_j = jl.svd3_for_essential(jnp.asarray(E))
    _close(U_t, U_j, atol=1e-5)
    _close(Vt_t, Vt_j, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(U_t.numpy()), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(Vt_t.numpy()), 1.0, atol=1e-5)


def test_inv3_and_spd_solve(rng):
    A3 = _spd(rng, 10, 3)
    _close(tl.inv3(_t(A3)), jl.inv3(jnp.asarray(A3)))
    A6 = _spd(rng, 10, 6)
    b = rng.normal(size=(10, 6)).astype(np.float32)
    got = tl.solve_spd_small(_t(A6), _t(b))
    _close(got, jl.solve_spd_small(jnp.asarray(A6), jnp.asarray(b)), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(A6, b[..., None])[..., 0],
                               rtol=1e-4, atol=1e-5)


def test_arrow_smallest_eigvec(rng):
    d = rng.uniform(0.5, 3.0, (4, 30)).astype(np.float32)
    c = rng.normal(0, 0.3, (4, 30)).astype(np.float32)
    g = (np.sum(c * c / d, -1) + rng.uniform(0.1, 1.0, 4)).astype(np.float32)
    lam_t, ratio_t = tl.arrow_smallest_eigvec(_t(d), _t(c), _t(g))
    lam_j, ratio_j = jl.arrow_smallest_eigvec(jnp.asarray(d), jnp.asarray(c), jnp.asarray(g))
    _close(lam_t, lam_j, atol=1e-6)
    _close(ratio_t, ratio_j, atol=1e-6)
