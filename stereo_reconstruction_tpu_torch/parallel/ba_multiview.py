"""Multi-view bundle adjustment: M cameras, distributed Schur complement.

Port of ``stereo_reconstruction_tpu/parallel/ba_multiview.py`` (BASELINE
config 5): the reference's two-view problem
(``src/PoseEstimation/bundle_adjustment.h:205-230``) grown to

* M cameras: camera 0 is the gauge (fixed at identity), cameras 1..M-1
  carry 6-DoF angle-axis + translation;
* N 3D points with per-observation weights (w[m, n] = 0: point n is not
  seen by camera m, so sparse tracks ride a dense layout);
* Levenberg-Marquardt with the point blocks eliminated: the reduced
  camera system is the 6M x 6M Schur complement S = B - sum_n E_n
  C_n^-1 E_n^T;
* the points split over the mesh: every shard eliminates its own points
  and the reduced system (36 M^2 + 6M floats) is ``psum``-ed, the only
  collective of an LM step besides the cost. Point back-substitution
  stays local.

``multiview_bundle_adjust`` is the same LM on a one-shard mesh of the
inputs' device. ``fuse_point_cloud`` ``all_gather``s the point shards, so
every shard holds the fused cloud.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from stereo_reconstruction_tpu_torch.config import BundleAdjustmentConfig
from stereo_reconstruction_tpu_torch.ops import geometry as geo
from stereo_reconstruction_tpu_torch.ops import small_linalg
from stereo_reconstruction_tpu_torch.parallel.mesh import Mesh, shard_map
from stereo_reconstruction_tpu_torch.pose.eight_point import pose_matrix


class MultiViewBAResult(NamedTuple):
    poses: torch.Tensor          # (M, 6) angle-axis + translation (cam 0 = 0)
    pose_matrices: torch.Tensor  # (M, 4, 4) world (= camera 0) -> camera m
    points: torch.Tensor         # (N, 3) optimised 3D points, world frame
    initial_cost: torch.Tensor   # () weighted sum of squared residuals
    final_cost: torch.Tensor


def _project_residual(pose6, X, obs, K):
    """(2,) reprojection residual of point X in the camera at pose6 (the
    reference's BundleAdjustmentConstraint, bundle_adjustment.h:134-161,
    for any camera): observation minus projection."""
    R = geo.angle_axis_to_rotation(pose6[:3])
    p = K @ (R @ X + pose6[3:])
    return obs - p[:2] / p[2]


# per (point, camera): residual and Jacobians, vmapped over cameras, then points
_per_cam = vmap(lambda pose6, x, o, K: (
    _project_residual(pose6, x, o, K),
    jacfwd(_project_residual, argnums=0)(pose6, x, o, K),
    jacfwd(_project_residual, argnums=1)(pose6, x, o, K)), in_dims=(0, None, 0, 0))
_per_point = vmap(_per_cam, in_dims=(None, 0, 0, None))
_residuals = vmap(vmap(_project_residual, in_dims=(0, None, 0, 0)),
                  in_dims=(None, 0, 0, None))


def _normal_blocks(poses, X_blk, obs_blk, w_blk, Ks, cam_mask):
    """The shard's Hessian blocks: B (M, 6, 6) block-diagonal camera
    Hessian, v (M, 6), E (Nl, M, 6, 3), C (Nl, 3, 3), g (Nl, 3)."""
    r, Jp, Jx = _per_point(poses, X_blk, obs_blk, Ks)    # (Nl, M, 2), (.., 2, 6), (.., 2, 3)
    w = w_blk[..., None]
    r = r * w
    Jp = Jp * (w * cam_mask[None, :, None])[..., None]   # the gauge camera's rows zeroed
    Jx = Jx * w[..., None]
    B = torch.einsum("nmri,nmrj->mij", Jp, Jp)
    v = -torch.einsum("nmri,nmr->mi", Jp, r)
    E = torch.einsum("nmri,nmrj->nmij", Jp, Jx)
    C = torch.einsum("nmri,nmrj->nij", Jx, Jx)
    g = -torch.einsum("nmri,nmr->ni", Jx, r)
    return B, v, E, C, g


def _block_diag(B, M):
    """(M, 6, 6) -> (6M, 6M) block diagonal."""
    out = torch.zeros((M, 6, M, 6), dtype=B.dtype, device=B.device)
    idx = torch.arange(M, device=B.device)
    out[idx, :, idx, :] = B
    return out.reshape(6 * M, 6 * M)


def _local_lm(config: BundleAdjustmentConfig, shard_axes: tuple):
    """The per-shard LM body over the shard's points."""

    async def psum_all(shard, x):
        for ax in shard_axes:
            x = await shard.psum(x, ax)
        return x

    async def local(shard, obs_blk, w_blk, X0_blk, poses0, Ks):
        M = poses0.shape[0]
        device = poses0.device
        cam_mask = (torch.arange(M, device=device) > 0).to(torch.float32)
        eye3 = torch.eye(3, device=device)
        eye6m = torch.eye(6 * M, device=device)
        gauge = torch.cat([torch.ones(6, device=device), torch.zeros(6 * (M - 1), device=device)])

        async def cost(poses, X_blk):
            r = _residuals(poses, X_blk, obs_blk, Ks)                      # (Nl, M, 2)
            return await psum_all(shard, torch.sum(torch.sum(r * r, -1) * w_blk * w_blk))

        poses, X_blk = poses0, X0_blk
        lam = torch.tensor(config.init_lambda, dtype=torch.float32, device=device)
        c0 = current_cost = await cost(poses, X_blk)
        for _ in range(config.max_iterations):
            B, v, E, C, g = _normal_blocks(poses, X_blk, obs_blk, w_blk, Ks, cam_mask)
            C_inv = small_linalg.inv3(C + lam * eye3)                      # (Nl, 3, 3)
            EC = torch.einsum("nmij,njk->nmik", E, C_inv)                  # (Nl, M, 6, 3)
            # S[m, m'] -= sum_n EC[n, m] E[n, m']^T: the full 6M x 6M coupling
            S_off = torch.einsum("nmik,npjk->mipj", EC, E)
            S = _block_diag(B, M) - S_off.reshape(6 * M, 6 * M)
            rhs = (v - torch.einsum("nmij,nj->mi", EC, g)).reshape(6 * M)
            # one packed psum per LM step
            packed = await psum_all(shard, torch.cat([S.reshape(-1), rhs]))
            S = packed[:36 * M * M].reshape(6 * M, 6 * M)
            rhs = packed[36 * M * M:]
            # the gauge: camera 0 pinned (unit diagonal, zero rhs), LM damping
            S = S + torch.diag(gauge) + lam * eye6m
            rhs = rhs * (1.0 - gauge)
            d_cam = torch.linalg.solve_ex(S, rhs)[0].reshape(M, 6) * cam_mask[:, None]
            Ed = torch.einsum("nmij,mi->nj", E, d_cam)
            d_X = torch.einsum("nij,nj->ni", C_inv, g - Ed)

            new_poses = poses + d_cam
            new_X = X_blk + d_X
            new_cost = await cost(new_poses, new_X)
            accept = new_cost < current_cost
            poses = torch.where(accept, new_poses, poses)
            X_blk = torch.where(accept, new_X, X_blk)
            lam = torch.where(accept,
                              torch.clamp(lam * config.lambda_down, min=config.min_lambda),
                              torch.clamp(lam * config.lambda_up, max=config.max_lambda))
            current_cost = torch.where(accept, new_cost, current_cost)
        return poses, X_blk, c0, current_cost

    return local


def _pack_result(poses_f, X_f, c0, cost_f) -> MultiViewBAResult:
    R = geo.angle_axis_to_rotation(poses_f[:, :3])
    return MultiViewBAResult(poses=poses_f, pose_matrices=pose_matrix(R, poses_f[:, 3:]),
                             points=X_f, initial_cost=c0, final_cost=cost_f)


def distributed_multiview_bundle_adjust(
    observations: torch.Tensor,   # (M, N, 2)
    intrinsics: torch.Tensor,     # (M, 3, 3)
    init_poses: torch.Tensor,     # (M, 6) angle-axis + t; row 0 is the gauge
    init_points: torch.Tensor,    # (N, 3)
    mesh,
    weights: Optional[torch.Tensor] = None,   # (M, N)
    config: BundleAdjustmentConfig = BundleAdjustmentConfig(),
    shard_axes: tuple = ("data", "tile"),
) -> MultiViewBAResult:
    """The points split over ``shard_axes`` (N must divide into the
    mesh's shards along them); one psum of the 6M x 6M system per LM
    step."""
    M, N = observations.shape[:2]
    w = (torch.ones((M, N), device=observations.device) if weights is None
         else weights.to(torch.float32))
    axes = tuple(shard_axes)
    out = shard_map(
        _local_lm(config, axes), mesh,
        [(axes, None, None), (axes, None), (axes, None), None, None],
        [(), (axes, None), (), ()],
        observations.transpose(0, 1), w.transpose(0, 1), init_points, init_poses,
        intrinsics)
    return _pack_result(*out)


def multiview_bundle_adjust(
    observations: torch.Tensor,   # (M, N, 2) pixel observations per camera
    intrinsics: torch.Tensor,     # (M, 3, 3)
    init_poses: torch.Tensor,     # (M, 6) angle-axis + t; row 0 is the gauge
    init_points: torch.Tensor,    # (N, 3) world (= camera 0) frame
    weights: Optional[torch.Tensor] = None,   # (M, N) observation weights
    config: BundleAdjustmentConfig = BundleAdjustmentConfig(),
) -> MultiViewBAResult:
    """The M-camera LM with every point on one device (the inputs')."""
    mesh = Mesh([observations.device], 1, 1)
    return distributed_multiview_bundle_adjust(
        observations, intrinsics, init_poses, init_points, mesh, weights, config)


def fuse_point_cloud(points_sharded: torch.Tensor, mesh,
                     shard_axes: tuple = ("data", "tile")) -> torch.Tensor:
    """``all_gather`` the point shards so every shard holds the fused cloud."""
    axes = tuple(shard_axes)

    async def local(shard, p_blk):
        return await shard.all_gather(p_blk, axes)

    return shard_map(local, mesh, [(axes, None)], (), points_sharded)
