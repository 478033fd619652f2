"""Loop-Zhang rectifying homographies, float64 NumPy: a copy of the
port's ``rectify/loop_zhang.py`` kept with the benchmark, so that a change
to the program cannot move the reference (Loop & Zhang, CVPR 1999; the
reference C++ ``rectification.cpp:53-379`` and ``z_optimization.hpp``).

H = H_s (shear, scale, translate) @ H_r (similarity) @ H_p (projective);
the projective step's z = (lambda, 1, 0) starts from the two generalised
eigenproblems and is refined by Newton on the distortion's derivative
(|f| < 1e-15 or 150 steps).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def loop_zhang_homographies(
    F: np.ndarray,
    shape_left: Tuple[int, int],   # (rows, cols)
    shape_right: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """(H_left, H_right), float64, of the fundamental matrix F."""
    F = np.asarray(F, dtype=np.float64)
    hl, wl = shape_left[:2]
    hr, wr = shape_right[:2]

    # ---- epipole: null vector of F (cv::SVD::solveZ, rectification.cpp:106-111)
    _, _, Vt = np.linalg.svd(F)
    e = Vt[-1]

    # ---- projective step (rectification.cpp:143-180)
    e_skew = np.array(
        [[0.0, -e[2], e[1]], [e[2], 0.0, -e[0]], [-e[1], e[0], 0.0]]
    )
    A, B = _compute_AB(wl, hl, e_skew)
    Ap, Bp = _compute_AB(wr, hr, F)

    z0 = _normalize(_maximize_addend(A, B)) + _normalize(_maximize_addend(Ap, Bp))
    z0 = z0 / 2.0
    lam = _newton_raphson(A, B, Ap, Bp, z0[0])
    z = np.array([lam, 1.0, 0.0])

    w_vec = e_skew @ z
    wp_vec = F @ z
    w_vec = w_vec / w_vec[2]
    wp_vec = wp_vec / wp_vec[2]

    H_p = np.eye(3)
    H_p[2, 0] = w_vec[0]
    H_p[2, 1] = w_vec[1]
    Hp_p = np.eye(3)
    Hp_p[2, 0] = wp_vec[0]
    Hp_p[2, 1] = wp_vec[1]

    # ---- similarity step (rectification.cpp:182-223)
    min_left = _min_y(_corners(wl, hl), H_p)
    min_right = _min_y(_corners(wr, hr), Hp_p)
    vp_c = -min(min_left, min_right)

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

    # ---- shearing step (rectification.cpp:274-379)
    H_1 = H_r @ H_p
    H_2 = Hp_r @ Hp_p
    S = _get_S(wl, hl, H_1)
    Sp = _get_S(wr, hr, H_2)

    area_in = wl * hl + wr * hr
    area_out = _contour_area(_transform(_corners(wl, hl), S @ H_1)) + _contour_area(
        _transform(_corners(wr, hr), Sp @ H_2)
    )
    scale = np.sqrt(area_in / max(area_out, 1e-12))

    if _is_inverted(hl, np.diag([scale, scale, 1.0]) @ H_1):
        scale = -scale
    W_2 = np.diag([scale, scale, 1.0])

    c1 = _transform(_corners(wl, hl), W_2 @ S @ H_1)
    c2 = _transform(_corners(wr, hr), W_2 @ Sp @ H_2)
    min_x_1, min_y_1 = c1.min(axis=0)
    min_x_2, min_y_2 = c2.min(axis=0)
    min_y = min(min_y_1, min_y_2)

    W_1 = np.eye(3)
    Wp_1 = np.eye(3)
    W_1[0, 2] = -min_x_1
    Wp_1[0, 2] = -min_x_2
    W_1[1, 2] = Wp_1[1, 2] = -min_y

    H_s = W_1 @ W_2 @ S
    Hp_s = Wp_1 @ W_2 @ Sp

    return H_s @ H_r @ H_p, Hp_s @ Hp_r @ Hp_p


# ---------------------------------------------------------------------------
# projective-step helpers
# ---------------------------------------------------------------------------

def _compute_AB(width: int, height: int, mat: np.ndarray):
    """rectification.cpp:116-141: A = M^T PP^T M, B = M^T p_c p_c^T M."""
    PPt = np.zeros((3, 3))
    PPt[0, 0] = width * width - 1
    PPt[1, 1] = height * height - 1
    PPt *= (width * height) / 12.0

    w1 = width - 1.0
    h1 = height - 1.0
    pcpct = np.array(
        [
            [w1 * w1, w1 * h1, 2 * w1],
            [w1 * h1, h1 * h1, 2 * h1],
            [2 * w1, 2 * h1, 4.0],
        ]
    ) / 4.0

    return mat.T @ PPt @ mat, mat.T @ pcpct @ mat


def _cholesky_tolerant(A: np.ndarray) -> np.ndarray:
    """The reference's custom 3x3 Cholesky (z_optimization.hpp:146-174):
    lower-triangular factor with tiny negative pivots (> -1e-5) flipped
    positive, returned transposed (upper-triangular)."""
    L = np.zeros((3, 3))
    for i in range(3):
        for j in range(i + 1):
            s = float(np.dot(L[i, :j], L[j, :j]))
            v = A[i, j] - s
            if i == j:
                if v < 0.0:
                    if v > -1e-5:
                        v = -v
                    else:
                        raise np.linalg.LinAlgError("matrix not PSD within tolerance")
                # A is rank-2 by construction (PP^T has a zero diagonal,
                # _compute_AB), so the last pivot is ~0. The reference's
                # f64 rounding leaves a tiny nonzero pivot and inverts it
                # (rectification.cpp:385); exact zeros must be nudged the
                # same way or D is singular.
                v = max(v, 1e-18)
                L[i, j] = np.sqrt(v)
            else:
                L[i, j] = v / L[j, j]
    return L.T


def _maximize_addend(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """rectification.cpp:381-398: generalized max eigenvector via D from
    the tolerant Cholesky of A; y = top eigenvector of D^{-T} B D^{-1}."""
    D = _cholesky_tolerant(A)
    D_inv = np.linalg.inv(D)
    DBD = D_inv.T @ B @ D_inv
    # cv::eigen: symmetric, eigenvectors as rows, DESCENDING eigenvalues
    vals, vecs = np.linalg.eigh(DBD)     # ascending, column vectors
    y = vecs[:, -1]                      # largest
    return D_inv @ y


def _rational_terms(A: np.ndarray, B: np.ndarray):
    """For z = (x, 1, 0): z^T A z = a00 x^2 + (a01+a10) x + a11 as a
    polynomial, same for B."""
    num = np.polynomial.Polynomial([A[1, 1], A[0, 1] + A[1, 0], A[0, 0]])
    den = np.polynomial.Polynomial([B[1, 1], B[0, 1] + B[1, 0], B[0, 0]])
    return num, den


def _newton_raphson(A, B, Ap, Bp, x0: float) -> float:
    """z_optimization.hpp:125-144: Newton on f(x) = d/dx [zAz/zBz +
    zA'z/zB'z], |f| < 1e-15 or 150 iterations. The derivative chain is
    computed with exact polynomial calculus (identical function values to
    the reference's hand-expanded forms)."""
    na, da = _rational_terms(A, B)
    nb, db = _rational_terms(Ap, Bp)

    # f = (na/da)' + (nb/db)' ; build numerators/denominators as polys
    def quotient_derivative(num, den):
        return num.deriv() * den - num * den.deriv(), den * den

    fa_n, fa_d = quotient_derivative(na, da)
    fb_n, fb_d = quotient_derivative(nb, db)

    dfa_n, dfa_d = quotient_derivative(fa_n, fa_d)
    dfb_n, dfb_d = quotient_derivative(fb_n, fb_d)

    def f(x):
        return fa_n(x) / fa_d(x) + fb_n(x) / fb_d(x)

    def df(x):
        return dfa_n(x) / dfa_d(x) + dfb_n(x) / dfb_d(x)

    x = float(x0)
    fx = f(x)
    dfx = df(x)
    for _ in range(150):
        x = x - fx / dfx
        fx = f(x)
        dfx = df(x)
        if abs(fx) <= 1e-15:
            break
    return x


# ---------------------------------------------------------------------------
# similarity/shear helpers
# ---------------------------------------------------------------------------

def _normalize(v: np.ndarray) -> np.ndarray:
    """cv::normalize of a Vec3d: unit L2 norm."""
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def _corners(width: int, height: int) -> np.ndarray:
    return np.array(
        [[0.0, 0.0], [width, 0.0], [width, height], [0.0, height]]
    )


def _transform(points: np.ndarray, H: np.ndarray) -> np.ndarray:
    hom = np.concatenate([points, np.ones((len(points), 1))], axis=1)
    out = hom @ H.T
    return out[:, :2] / out[:, 2:3]


def _min_y(points: np.ndarray, H: np.ndarray) -> float:
    return float(_transform(points, H)[:, 1].min())


def _contour_area(points: np.ndarray) -> float:
    """cv::contourArea — shoelace absolute area."""
    x, y = points[:, 0], points[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def _is_inverted(height: int, H: np.ndarray) -> bool:
    """rectification.cpp:420-430: (0,0) vs (0, h) flip test."""
    pts = _transform(np.array([[0.0, 0.0], [0.0, float(height)]]), H)
    return bool(pts[1, 1] - pts[0, 1] < 0.0)


def _get_S(width: int, height: int, H: np.ndarray) -> np.ndarray:
    """Shearing transform (rectification.cpp:225-272). Midpoint coords use
    C++ integer division on (w-1)/2, (h-1)/2 — replicated."""
    a = [(width - 1) // 2, 0.0]
    b = [width - 1.0, (height - 1) // 2]
    c = [(width - 1) // 2, height - 1.0]
    d = [0.0, (height - 1) // 2]
    mids = _transform(np.array([a, b, c, d], dtype=np.float64), H)
    x = mids[1] - mids[3]
    y = mids[2] - mids[0]

    h, w = float(height), float(width)
    denom_a = h * w * (x[1] * y[0] - x[0] * y[1])
    denom_b = h * w * (x[0] * y[1] - x[1] * y[0])
    coeff_a = (h * h * x[1] * x[1] + w * w * y[1] * y[1]) / denom_a
    coeff_b = (h * h * x[0] * x[1] + w * w * y[0] * y[1]) / denom_b

    if coeff_a < 0:
        coeff_a = -coeff_a
        coeff_b = -coeff_b

    S = np.eye(3)
    S[0, 0] = coeff_a
    S[0, 1] = coeff_b
    return S
