"""Eight-point essential-matrix estimation, batched.

Port of ``stereo_reconstruction_tpu/pose/eight_point.py`` (reference
``EightPointAlgorithm``, ``src/PoseEstimation/eight_point.cpp:26-147``):
chi from Kronecker products, the smallest eigenvector of chi^T chi,
projection onto the essential space, the four (R, T) candidates from
+-Rz(90 deg), and cheirality by joint-depth triangulation. It takes the
batched RANSAC call ((K, 3, s) matches) and the unbatched refit call
((3, N) matches) alike; all four candidates are triangulated at once and
the first with every depth >= 0 wins (``valid`` replaces the reference's
``throw``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_reconstruction_tpu_torch.ops import geometry as geo
from stereo_reconstruction_tpu_torch.ops import small_linalg


class EightPointResult(NamedTuple):
    rotation: torch.Tensor       # (..., 3, 3)
    translation: torch.Tensor    # (..., 3)
    essential: torch.Tensor      # (..., 3, 3)
    pose: torch.Tensor           # (..., 4, 4)
    depths_left: torch.Tensor    # (..., N)
    points_left: torch.Tensor    # (..., 3, N) reconstructed 3D (left frame)
    points_right: torch.Tensor   # (..., 3, N) reconstructed 3D (right frame)
    valid: torch.Tensor          # (...,) bool: cheirality satisfied


def pose_matrix(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) [[R, T], [0, 1]], built out of place so that
    ``torch.func.vmap`` batches it."""
    bottom = geo.constant((0.0, 0.0, 0.0, 1.0), R.dtype, R.device)
    top = torch.cat([R, T[..., :, None]], dim=-1)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def eight_point(
    matches_left: torch.Tensor,    # (..., 3, N) homogeneous pixel coords
    matches_right: torch.Tensor,   # (..., 3, N)
    K_left: torch.Tensor,          # (3, 3) or (..., 3, 3)
    K_right: torch.Tensor,
) -> EightPointResult:
    """The eight-point algorithm on N >= 8 correspondences."""
    xl = geo.normalize_points(K_left, matches_left)
    xr = geo.normalize_points(K_right, matches_right)

    # chi[i] = kron(xl_i, xr_i) (eight_point.cpp:30-33); the right singular
    # vector of chi for the smallest singular value is the smallest
    # eigenvector of chi^T chi; Eigen's column-major reshaped(3, 3) makes
    # E[r, c] = e[c*3 + r]
    chi = geo.kron_vec(xl.mT, xr.mT)                      # (..., N, 9)
    e_vec = small_linalg.smallest_eigvec(chi.mT @ chi)    # (..., 9)
    E0 = e_vec.reshape(*e_vec.shape[:-1], 3, 3).mT

    # essential-space projection (eight_point.cpp:40-51): det(U) = det(V)
    # = +1 already, the state after the reference's sign fix
    U, Vt = small_linalg.svd3_for_essential(E0)
    dtype, device = E0.dtype, E0.device
    sigma = torch.diag(geo.constant((1.0, 1.0, 0.0), dtype, device))
    Rz = geo.constant(((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)), dtype, device)

    def candidate(Rz_k):
        R = U @ Rz_k.T @ Vt
        T_skew = U @ Rz_k @ sigma @ U.mT
        T = torch.stack([-T_skew[..., 1, 2], T_skew[..., 0, 2], -T_skew[..., 0, 1]],
                        dim=-1)
        return R, T

    R1, T1 = candidate(Rz)
    R2, T2 = candidate(Rz.T)
    # the reference's order (eight_point.cpp:72-87): (R1,T1), (R1,T2),
    # (R2,T1), (R2,T2), triangulated as one batch of 4
    Rs = torch.stack([R1, R1, R2, R2], dim=0)             # (4, ..., 3, 3)
    Ts = torch.stack([T1, T2, T1, T2], dim=0)
    depths4 = geo.triangulate_depths(xl, xr, Rs, Ts)      # (4, ..., N)
    pl4 = xl * depths4[..., None, :]
    pr4 = geo.transform(Rs, Ts, pl4)
    ok4 = torch.all(pl4[..., 2, :] >= 0, dim=-1) & torch.all(pr4[..., 2, :] >= 0, dim=-1)

    # first valid candidate wins (the reference breaks on first success)
    first = torch.argmax(ok4.to(torch.int8), dim=0)      # (...,)
    valid = torch.any(ok4, dim=0)

    def take(arr):
        idx = first.reshape((1,) + first.shape + (1,) * (arr.ndim - 1 - first.ndim))
        idx = idx.expand((1,) + arr.shape[1:])
        return torch.gather(arr, 0, idx)[0]

    R = take(Rs)
    T = take(Ts)
    return EightPointResult(R, T, geo.essential_from_pose(R, T), pose_matrix(R, T),
                            take(depths4), take(pl4), take(pr4), valid)


def reprojection_errors(result: EightPointResult, matches_right: torch.Tensor,
                        K_right: torch.Tensor) -> torch.Tensor:
    """Per-point pixel error of the reconstructed points projected into the
    right camera (reference RANSAC scoring, eight_point.cpp:282-287)."""
    return geo.pixel_error(geo.project(K_right, result.points_right), matches_right)


def fundamental_matrix(result: EightPointResult, K_left, K_right) -> torch.Tensor:
    """F of the result's essential matrix, at unit Frobenius norm (each
    matrix of a batch on its own)."""
    return geo.fundamental_from_essential(result.essential, K_left, K_right)
