"""Batched small-matrix solvers of the pose stage, as elementwise code.

Port of ``stereo_reconstruction_tpu/ops/small_linalg.py``. These define
the JAX package's pose outputs, so they are ported as written rather than
replaced by ``torch.linalg.eigh``/``svd``:

* ``jacobi_eigh``: fixed-sweep cyclic Jacobi for symmetric n <= ~12
  batches; each rotation updates rows p, q and then columns p, q of the
  batched tensor in place;
* ``svd3_for_essential``: the 3x3 SVD the essential-matrix projection
  needs, with det(U) = det(V) = +1 by construction;
* ``inv3`` and ``solve_spd_small``: closed-form 3x3 inverse and unrolled
  Cholesky solve of the bundle adjustment's Schur step;
* ``arrow_smallest_eigvec``: the smallest eigenpair of an arrow matrix
  from its secular equation, O(N) per iteration.
"""

from __future__ import annotations

import torch


def jacobi_eigh(A: torch.Tensor, sweeps: int = 6):
    """(eigenvalues ascending, eigenvectors as columns) of a symmetric
    (..., n, n) batch by ``sweeps`` cyclic Jacobi sweeps."""
    n = A.shape[-1]
    A = 0.5 * (A + A.mT)
    V = torch.eye(n, dtype=A.dtype, device=A.device) + 0.0 * A
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app = A[..., p, p]
                aqq = A[..., q, q]
                apq = A[..., p, q]
                small = torch.abs(apq) <= 1e-37
                tau = (aqq - app) / torch.where(small, torch.ones_like(apq), 2.0 * apq)
                root = torch.sqrt(1.0 + tau * tau)
                sign = torch.sign(tau)
                t = torch.where(sign == 0.0, 1.0 / (tau + root),
                                sign / (torch.abs(tau) + root))
                c = 1.0 / torch.sqrt(1.0 + t * t)
                s = t * c
                c = torch.where(small, torch.ones_like(c), c)[..., None]
                s = torch.where(small, torch.zeros_like(s), s)[..., None]
                # A <- J^T A J: rows p, q, then columns p, q
                Ap, Aq = A[..., p, :].clone(), A[..., q, :].clone()
                A[..., p, :] = c * Ap - s * Aq
                A[..., q, :] = s * Ap + c * Aq
                Ap, Aq = A[..., :, p].clone(), A[..., :, q].clone()
                A[..., :, p] = c * Ap - s * Aq
                A[..., :, q] = s * Ap + c * Aq
                Vp, Vq = V[..., :, p].clone(), V[..., :, q].clone()
                V[..., :, p] = c * Vp - s * Vq
                V[..., :, q] = s * Vp + c * Vq
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    w = torch.take_along_dim(w, order, dim=-1)
    V = torch.take_along_dim(V, order[..., None, :], dim=-1)
    return w, V


def smallest_eigvec(A: torch.Tensor, sweeps: int = 6) -> torch.Tensor:
    """Unit eigenvector (..., n) of the smallest eigenvalue."""
    _, V = jacobi_eigh(A, sweeps=sweeps)
    return V[..., :, 0]


def svd3_for_essential(E: torch.Tensor, sweeps: int = 8):
    """(U, Vt) of a (..., 3, 3) batch with det(U) = det(Vt) = +1, from a
    Jacobi eigh of E^T E: V holds the singular vectors in descending
    order; U's columns are the normalised E v_1, E v_2 (Gram-Schmidt) and
    their cross product, so sigma_3 ~ 0 is never divided by."""
    w, V = jacobi_eigh(E.mT @ E, sweeps=sweeps)
    V = V.flip(-1)
    v1 = V[..., :, 0]
    v2 = V[..., :, 1]

    def unit(x):
        return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-30)

    u1 = unit((E @ v1[..., None])[..., 0])
    u2raw = (E @ v2[..., None])[..., 0]
    u2 = unit(u2raw - torch.sum(u2raw * u1, dim=-1, keepdim=True) * u1)
    u3 = torch.linalg.cross(u1, u2, dim=-1)
    U = torch.stack([u1, u2, u3], dim=-1)
    V = V.clone()
    V[..., :, 2] *= torch.sign(torch.linalg.det(V))[..., None]
    return U, V.mT


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Adjugate inverse of a (..., 3, 3) batch."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11 = e * i - f * h
    c12 = c * h - b * i
    c13 = b * f - c * e
    c21 = f * g - d * i
    c22 = a * i - c * g
    c23 = c * d - a * f
    c31 = d * h - e * g
    c32 = b * g - a * h
    c33 = a * e - b * d
    det = a * c11 + b * c21 + c * c31
    adj = torch.stack([
        torch.stack([c11, c12, c13], dim=-1),
        torch.stack([c21, c22, c23], dim=-1),
        torch.stack([c31, c32, c33], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]


def solve_spd_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for a small symmetric positive-definite (..., n, n)
    batch: unrolled Cholesky, then forward and back substitution."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp_min(s, 1e-30))
        for i2 in range(j + 1, n):
            s = A[..., i2, j]
            for k in range(j):
                s = s - L[i2][k] * L[j][k]
            L[i2][j] = s / L[j][j]
    y = [None] * n
    for i2 in range(n):
        s = b[..., i2]
        for k in range(i2):
            s = s - L[i2][k] * y[k]
        y[i2] = s / L[i2][i2]
    x = [None] * n
    for i2 in reversed(range(n)):
        s = y[i2]
        for k in range(i2 + 1, n):
            s = s - L[k][i2] * x[k]
        x[i2] = s / L[i2][i2]
    return torch.stack(x, dim=-1)


def _guard(denom: torch.Tensor) -> torch.Tensor:
    """Push |denom| < 1e-30 out to +-1e-30, keeping its sign."""
    tiny = torch.where(denom < 0, -1e-30, 1e-30)
    return torch.where(torch.abs(denom) < 1e-30, tiny, denom)


def arrow_smallest_eigvec(
    diag: torch.Tensor,      # (..., N) positive diagonal d
    cross: torch.Tensor,     # (..., N) border column c
    corner: torch.Tensor,    # (...,)   corner g
    bisect_iters: int = 30,
    newton_iters: int = 3,
):
    """Smallest eigenpair of the PSD arrow matrix [[diag(d), c], [c^T, g]]
    as (lambda, ratio), ratio_i = v_i / v_N = -c_i / (d_i - lambda).

    lambda is the root of f(lam) = (g - lam) - sum_i c_i^2 / (d_i - lam)
    on [0, min_i d_i), where f decreases from the Schur complement f(0) >= 0
    to -inf: bisection brackets it, clamped Newton polishes it."""
    d_min = torch.amin(diag, dim=-1)
    eps = 1e-7 * torch.clamp_min(d_min, 1e-30)
    c2 = cross * cross

    def f(lam):
        return (corner - lam) - torch.sum(c2 / _guard(diag - lam[..., None]), dim=-1)

    lo = torch.zeros_like(d_min)
    hi = torch.clamp_min(d_min - eps, 0.0)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        go_right = f(mid) > 0
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    lam = 0.5 * (lo + hi)
    for _ in range(newton_iters):
        denom = diag - lam[..., None]
        denom = torch.where(torch.abs(denom) < 1e-30, 1e-30, denom)
        fp = -1.0 - torch.sum(c2 / (denom * denom), dim=-1)
        lam = torch.minimum(torch.maximum(lam - f(lam) / fp, lo), hi)
    ratio = -cross / _guard(diag - lam[..., None])
    return lam, ratio
