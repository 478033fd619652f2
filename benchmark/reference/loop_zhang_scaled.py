"""Loop-Zhang rectifying homographies whose tolerant Cholesky accepts a
negative pivot down to a bound scaled to A: ``loop_zhang.py``'s chain
with its helpers, in a file of its own so that neither ``loop_zhang.py``
nor the reference it serves moves.

A = [e]x^T PP^T [e]x is PSD of rank 2 with a norm near 3e10 at 750x900,
so its last pivot is a difference of numbers near 3e10, and rounding
alone leaves it a few float64 ulps of them either side of zero. The
absolute -1e-5 of the reference (``z_optimization.hpp:146-174``) rejects
such an A: an F posed 0.027 / 0.230 degrees from the truth gave the
pivots 2549.5, 3671.3 and -1.1444e-5, 1.6 ulps of A[2, 2]. Here a pivot
is accepted down to -max(1e-5, 64 eps max(diag A)) and flipped positive;
a pivot the absolute bound accepted gives the same factor as there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from benchmark.reference.loop_zhang import (
    _compute_AB,
    _contour_area,
    _corners,
    _get_S,
    _is_inverted,
    _min_y,
    _newton_raphson,
    _normalize,
    _transform,
)

PIVOT_ULPS = 64.0


def pivot_tolerance(A: np.ndarray) -> float:
    """The most negative pivot accepted, as a positive number."""
    return max(1e-5, PIVOT_ULPS * np.finfo(np.float64).eps * float(np.max(np.diag(A))))


def cholesky_tolerant(A: np.ndarray) -> np.ndarray:
    """The 3x3 Cholesky factor of A, upper-triangular, with negative
    pivots down to -``pivot_tolerance(A)`` flipped positive and exact
    zeros raised to 1e-18 (``loop_zhang._cholesky_tolerant``'s rules
    otherwise)."""
    tol = pivot_tolerance(A)
    L = np.zeros((3, 3))
    for i in range(3):
        for j in range(i + 1):
            v = A[i, j] - float(np.dot(L[i, :j], L[j, :j]))
            if i == j:
                if v < 0.0:
                    if v < -tol:
                        raise np.linalg.LinAlgError("matrix not PSD within tolerance")
                    v = -v
                L[i, j] = np.sqrt(max(v, 1e-18))
            else:
                L[i, j] = v / L[j, j]
    return L.T


def _maximize_addend(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """The generalised top eigenvector of (B, A) through the factor of A
    (rectification.cpp:381-398)."""
    D_inv = np.linalg.inv(cholesky_tolerant(A))
    _, vecs = np.linalg.eigh(D_inv.T @ B @ D_inv)
    return D_inv @ vecs[:, -1]


def loop_zhang_homographies(
    F: np.ndarray,
    shape_left: Tuple[int, int],   # (rows, cols)
    shape_right: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """(H_left, H_right), float64, of the fundamental matrix F: the steps
    of ``loop_zhang.loop_zhang_homographies``."""
    F = np.asarray(F, dtype=np.float64)
    hl, wl = shape_left[:2]
    hr, wr = shape_right[:2]

    _, _, Vt = np.linalg.svd(F)
    e = Vt[-1]
    e_skew = np.array([[0.0, -e[2], e[1]], [e[2], 0.0, -e[0]], [-e[1], e[0], 0.0]])
    A, B = _compute_AB(wl, hl, e_skew)
    Ap, Bp = _compute_AB(wr, hr, F)

    # projective step
    z0 = (_normalize(_maximize_addend(A, B)) + _normalize(_maximize_addend(Ap, Bp))) / 2.0
    lam = _newton_raphson(A, B, Ap, Bp, z0[0])
    z = np.array([lam, 1.0, 0.0])
    w_vec = e_skew @ z
    wp_vec = F @ z
    w_vec = w_vec / w_vec[2]
    wp_vec = wp_vec / wp_vec[2]
    H_p, Hp_p = np.eye(3), np.eye(3)
    H_p[2, :2] = w_vec[:2]
    Hp_p[2, :2] = wp_vec[:2]

    # similarity step
    vp_c = -min(_min_y(_corners(wl, hl), H_p), _min_y(_corners(wr, hr), Hp_p))
    H_r = np.zeros((3, 3))
    H_r[0, 0] = F[2, 1] - w_vec[1] * F[2, 2]
    H_r[1, 0] = F[2, 0] - w_vec[0] * F[2, 2]
    H_r[0, 1] = w_vec[0] * F[2, 2] - F[2, 0]
    H_r[1, 1] = H_r[0, 0]
    H_r[1, 2] = F[2, 2] + vp_c
    H_r[2, 2] = 1.0
    Hp_r = np.zeros((3, 3))
    Hp_r[0, 0] = wp_vec[1] * F[2, 2] - F[1, 2]
    Hp_r[1, 0] = wp_vec[0] * F[2, 2] - F[0, 2]
    Hp_r[0, 1] = F[0, 2] - wp_vec[0] * F[2, 2]
    Hp_r[1, 1] = Hp_r[0, 0]
    Hp_r[1, 2] = vp_c
    Hp_r[2, 2] = 1.0

    # shearing step
    H_1, H_2 = H_r @ H_p, Hp_r @ Hp_p
    S, Sp = _get_S(wl, hl, H_1), _get_S(wr, hr, H_2)
    area_out = (_contour_area(_transform(_corners(wl, hl), S @ H_1))
                + _contour_area(_transform(_corners(wr, hr), Sp @ H_2)))
    scale = np.sqrt((wl * hl + wr * hr) / max(area_out, 1e-12))
    if _is_inverted(hl, np.diag([scale, scale, 1.0]) @ H_1):
        scale = -scale
    W_2 = np.diag([scale, scale, 1.0])
    min_x_1, min_y_1 = _transform(_corners(wl, hl), W_2 @ S @ H_1).min(axis=0)
    min_x_2, min_y_2 = _transform(_corners(wr, hr), W_2 @ Sp @ H_2).min(axis=0)
    W_1, Wp_1 = np.eye(3), np.eye(3)
    W_1[0, 2], Wp_1[0, 2] = -min_x_1, -min_x_2
    W_1[1, 2] = Wp_1[1, 2] = -min(min_y_1, min_y_2)

    return W_1 @ W_2 @ S @ H_r @ H_p, Wp_1 @ W_2 @ Sp @ Hp_r @ Hp_p
