"""The port's tolerant Cholesky (``rectify/loop_zhang.py::_cholesky_tolerant``)
against JAX's host copy, which keeps the reference's absolute -1e-5 bound.

A = [e]x^T PP^T [e]x is PSD of rank 2 with a norm near 3e10 at 750x900,
so rounding leaves its last pivot a few ulps of ~3e10 either side of zero.
The witness is the F the port's pose stage found for benchmark seed
3000000005, scene 0, draws of request 0 from a CPU generator (0.027 /
0.230 degrees from the truth): pivots 2549.5, 3671.3 and -1.1444e-5. The
port rectifies it, JAX raises (a divergence from the reference, recorded
in ROADMAP.md). Where the absolute bound accepts, the factors are the
same bit for bit.
"""

import numpy as np
import pytest
import torch

from stereo_reconstruction_tpu.rectify import loop_zhang as jlz
from stereo_reconstruction_tpu_torch.rectify import loop_zhang as tlz

torch.set_num_threads(1)

WITNESS_F = np.array([
    [6.5811555316486192e-08, -3.3362659905833425e-06, 2.3756748996675014e-03],
    [5.1497413551260252e-06, 4.1241560211346950e-07, 1.7570877447724342e-02],
    [-3.2405538950115442e-03, -1.8987802788615227e-02, 9.9965721368789673e-01],
])


def _skew(e):
    return np.array([[0.0, -e[2], e[1]], [e[2], 0.0, -e[0]], [-e[1], e[0], 0.0]])


def _pivots(A):
    """The diagonal pivots of the factorisation, before any flip."""
    L, out = np.zeros((3, 3)), []
    for i in range(3):
        for j in range(i + 1):
            v = A[i, j] - float(np.dot(L[i, :j], L[j, :j]))
            if i == j:
                out.append(v)
                L[i, j] = np.sqrt(max(abs(v), 1e-18))
            else:
                L[i, j] = v / L[j, j]
    return out


def _left_A(F, w, h):
    _, _, Vt = np.linalg.svd(F)
    return tlz._compute_AB(w, h, _skew(Vt[-1]))[0]


def _planted(seed):
    """Q diag(3.2e10, 3.6e3, 0) Q^T for a seeded rotation Q: PSD of rank 2,
    at the witness's scale."""
    Q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return Q @ np.diag([3.2e10, 3.6e3, 0.0]) @ Q.T


def test_witness_F_rectifies_in_the_port_and_raises_in_jax():
    A = _left_A(WITNESS_F, 900, 750)
    last = _pivots(A)[2]
    assert -tlz.pivot_tolerance(A) <= last < -1e-5
    assert np.linalg.eigvalsh(A).min() > -1e-3 * np.finfo(np.float64).eps * np.abs(A).max()
    got = tlz.loop_zhang_homographies(WITNESS_F, (750, 900), (750, 900))
    assert np.isfinite(got.H_left).all() and np.isfinite(got.H_right).all()
    with pytest.raises(np.linalg.LinAlgError):
        jlz.loop_zhang_homographies(WITNESS_F, (750, 900), (750, 900))


@pytest.mark.parametrize("seed", [28, 63])
def test_planted_psd_matrix_whose_last_pivot_rounds_negative(seed):
    A = _planted(seed)
    last = _pivots(A)[2]
    assert -tlz.pivot_tolerance(A) <= last < -1e-5
    with pytest.raises(np.linalg.LinAlgError):
        jlz._cholesky_tolerant(A)
    U = tlz._cholesky_tolerant(A)
    assert U[2, 2] == np.sqrt(-last)                     # flipped positive
    np.testing.assert_allclose(U.T @ U, A, rtol=0, atol=1e-12 * np.abs(A).max())


def test_a_pivot_past_the_scaled_bound_still_raises():
    A = _planted(28)
    A[2, 2] -= 2 * tlz.pivot_tolerance(A)
    with pytest.raises(np.linalg.LinAlgError):
        tlz._cholesky_tolerant(A)
    with pytest.raises(np.linalg.LinAlgError):
        tlz._cholesky_tolerant(np.diag([1.0, 1.0, -1.0]))


def _accepted_inputs():
    """(name, A): matrices the absolute bound accepts. The A and A' of
    true F's at 320x240 and 900x750, planted ones whose last pivot lands
    just above -1e-5, at 0 and positive, and a well-conditioned one."""
    out = []
    for w, h, rvec, T in [(320, 240, [0.02, -0.08, 0.01], [-1.0, 0.05, 0.15]),
                          (900, 750, [0.02, -0.08, 0.01], [-1.0, 0.05, 0.15]),
                          (900, 750, [-0.01, 0.03, 0.02], [-1.0, -0.1, 0.05])]:
        K = np.array([[float(w), 0, w / 2], [0, float(w), h / 2], [0, 0, 1]])
        th = np.linalg.norm(rvec)
        k = np.asarray(rvec) / th
        Kx = _skew(k)
        R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
        T = np.asarray(T, np.float64) / np.linalg.norm(T)
        F = np.linalg.inv(K).T @ _skew(T) @ R @ np.linalg.inv(K)
        F = F / np.linalg.norm(F)
        out.append((f"A {w}x{h} {rvec}", _left_A(F, w, h)))
        out.append((f"A' {w}x{h} {rvec}", tlz._compute_AB(w, h, F)[0]))
    base = np.diag([4.0, 9.0, 0.0])
    for v in (-9.5e-6, -1e-12, 0.0, 2e-7):
        A = base.copy()
        A[2, 2] = v
        out.append((f"pivot {v}", A))
    out.append(("well conditioned", np.array([[4.0, 2.0, 0.6], [2.0, 5.0, 1.5],
                                              [0.6, 1.5, 3.0]])))
    return out


@pytest.mark.parametrize("name,A", _accepted_inputs(), ids=[n for n, _ in _accepted_inputs()])
def test_factor_is_bit_identical_where_the_absolute_bound_accepts(name, A):
    want = jlz._cholesky_tolerant(A)
    got = tlz._cholesky_tolerant(A)
    assert np.array_equal(got, want)
