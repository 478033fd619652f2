"""Projective-geometry primitives on batched tensors.

Port of ``stereo_reconstruction_tpu/ops/geometry.py`` (reference
``src/utils.cpp``): skew matrices, Kronecker products, projections,
pixel errors, the Rodrigues maps and the joint-depth triangulation.
Points are (..., 3, N) homogeneous column matrices, as in the
reference's Eigen ``Matrix3Xf`` layout; every function broadcasts over
leading dimensions and runs on its inputs' device.
"""

from __future__ import annotations

import torch

from stereo_reconstruction_tpu_torch.ops.cost_volume import sqrt_rn


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix (reference utils.cpp:23-34):
    (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def kron_vec(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[i*m + j] = a[i] * b[j] (reference utils.cpp:37-47), batched."""
    return (a[..., :, None] * b[..., None, :]).reshape(*a.shape[:-1], -1)


def to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """(..., 2, N) pixel coordinates -> (..., 3, N) homogeneous."""
    return torch.cat([points, torch.ones_like(points[..., :1, :])], dim=-2)


def from_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """(..., 3, N) -> (..., 2, N), dividing by the last row."""
    return points[..., :2, :] / points[..., 2:3, :]


def normalize_points(K: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """K^{-1} @ points for an upper-triangular K by exact back-substitution
    (reference eight_point.cpp:149-154). K (..., 3, 3), points (..., 3, N)."""
    p0, p1, p2 = points[..., 0, :], points[..., 1, :], points[..., 2, :]
    k00 = K[..., 0, 0, None]
    k01 = K[..., 0, 1, None]
    k02 = K[..., 0, 2, None]
    k11 = K[..., 1, 1, None]
    k12 = K[..., 1, 2, None]
    k22 = K[..., 2, 2, None]
    u2 = p2 / k22
    u1 = (p1 - k12 * u2) / k11
    u0 = (p0 - k01 * u1 - k02 * u2) / k00
    return torch.stack([u0, u1, u2], dim=-2)


def project(K: torch.Tensor, points3d: torch.Tensor) -> torch.Tensor:
    """(K @ X) / X_z: homogeneous pixels whose third row is 1
    (reference utils.cpp:106)."""
    return (K @ points3d) / points3d[..., 2:3, :]


def transform(R: torch.Tensor, T: torch.Tensor, points3d: torch.Tensor) -> torch.Tensor:
    """R @ X + T for (..., 3, N) points."""
    return R @ points3d + T[..., :, None]


def column_norm(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over axis -2, sqrt correctly rounded."""
    return sqrt_rn(torch.sum(d * d, dim=-2))


def pixel_error(projected: torch.Tensor, observed: torch.Tensor) -> torch.Tensor:
    """Per-point pixel error over the first two rows (reference
    calculateEuclideanPixelError, eight_point.cpp:363-370)."""
    return column_norm(projected[..., :2, :] - observed[..., :2, :])


def average_reconstruction_error(
    matches_left: torch.Tensor,
    matches_right: torch.Tensor,
    K_left: torch.Tensor,
    K_right: torch.Tensor,
    rotation: torch.Tensor,
    translation: torch.Tensor,
    points_left_3d: torch.Tensor,
) -> torch.Tensor:
    """Two-view mean reprojection error (reference utils.cpp:98-120).

    Note the reference uses the *3-row* homogeneous difference norm (its
    projected third row is exactly 1 and the matches' third row is 1, so it
    equals the 2-row pixel norm)."""
    err_left = column_norm(project(K_left, points_left_3d) - matches_left).mean(dim=-1)
    points_right = transform(rotation, translation, points_left_3d)
    err_right = column_norm(project(K_right, points_right) - matches_right).mean(dim=-1)
    return (err_left + err_right) / 2.0


def fundamental_from_essential(E, K_left, K_right) -> torch.Tensor:
    """F = K_r^{-T} E K_l^{-1}, each matrix at unit Frobenius norm
    (reference eight_point.cpp:205-208; the JAX callers vmap it)."""
    F = torch.linalg.inv(K_right).mT @ E @ torch.linalg.inv(K_left)
    norm = sqrt_rn(torch.sum(F * F, dim=(-2, -1), keepdim=True))
    return F / norm


def essential_from_pose(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """E = [T]_x R (reference eight_point.cpp:93)."""
    return skew(T) @ R


def angle_axis_to_rotation(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) angle-axis -> (..., 3, 3), with R ~ I + [aa]_x
    below theta^2 = 1e-12 (replaces ceres::AngleAxisRotatePoint,
    bundle_adjustment.h:83)."""
    theta2 = torch.sum(aa * aa, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(torch.clamp_min(theta2, 1e-24))
    K = skew(aa / torch.clamp_min(theta[..., 0], 1e-12))
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)
    return torch.where(theta2 < 1e-12, eye + skew(aa), R)


def rotation_to_angle_axis(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) angle-axis (reference rotToAngleAxis,
    bundle_adjustment.h:32-35)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    axis_raw = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    scale = torch.where(
        torch.abs(sin_theta) > 1e-6,
        theta / (2.0 * torch.clamp_min(torch.abs(sin_theta), 1e-12)),
        torch.full_like(theta, 0.5),
    )
    return axis_raw * scale[..., None]


def triangulate_depths(
    points_left_norm: torch.Tensor,   # (..., 3, N) K^-1-normalised left points
    points_right_norm: torch.Tensor,  # (..., 3, N)
    R: torch.Tensor,                  # (..., 3, 3)
    T: torch.Tensor,                  # (..., 3)
) -> torch.Tensor:
    """Joint depths of all N matches (reference ``estimateDepth``,
    eight_point.cpp:120-147): the smallest eigenvector of M^T M, with
    M[3i:3i+3, i] = [x_r]_x R x_l and M[3i:3i+3, N] = [x_r]_x T, scaled so
    the translation coefficient is 1. M^T M is an arrow matrix, solved in
    O(N) by ``arrow_smallest_eigvec``. Returns (..., N)."""
    from stereo_reconstruction_tpu_torch.ops.small_linalg import arrow_smallest_eigvec

    Rxl = (R @ points_left_norm).mT                        # (..., N, 3)
    skew_xr = skew(points_right_norm.mT)                   # (..., N, 3, 3)
    col_i = (skew_xr @ Rxl[..., :, None])[..., 0]          # (..., N, 3)
    col_T = (skew_xr @ T[..., None, :, None])[..., 0]

    diag = torch.sum(col_i * col_i, dim=-1)                # (..., N)
    cross = torch.sum(col_i * col_T, dim=-1)
    corner = torch.sum(col_T * col_T, dim=-1).sum(dim=-1)  # (...,)
    _, depths = arrow_smallest_eigvec(diag, cross, corner)
    return depths
