"""Distributed Schur-complement bundle adjustment.

Port of ``stereo_reconstruction_tpu/parallel/ba_dist.py``: the two-view
LM of ``pose/ba.py`` with the 3D points split over the mesh. Each shard
eliminates its own point blocks; the reduced 6x6 camera system (S, rhs),
42 floats, is ``psum``-ed across the mesh in one packed collective per LM
iteration, and the costs of the accept test in one more. The pose update
is computed on every shard alike, the point back-substitution stays
local. The batched form advances B independent problems in lockstep and
reduces their systems as one (B, 42) ``psum``.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from stereo_reconstruction_tpu_torch.config import BundleAdjustmentConfig
from stereo_reconstruction_tpu_torch.ops import geometry as geo
from stereo_reconstruction_tpu_torch.ops import small_linalg
from stereo_reconstruction_tpu_torch.parallel.mesh import shard_map
from stereo_reconstruction_tpu_torch.pose.ba import BAResult, _residuals_one
from stereo_reconstruction_tpu_torch.pose.eight_point import pose_matrix


def _local_lm(config: BundleAdjustmentConfig, shard_axes: tuple):
    """The per-shard body: B problems (leading axis) of the shard's points."""

    async def psum_all(shard, x):
        for ax in shard_axes:
            x = await shard.psum(x, ax)
        return x

    async def local(shard, kp_l, kp_r, w, X0, pose0, K_left, K_right):
        # kp_l, kp_r, X0 (B, Nl, 3), w (B, Nl), pose0 (B, 6)
        def res_fn(pose6, X, kl, kr):
            return _residuals_one(pose6, X, kl, kr, K_left, K_right)

        residuals = vmap(vmap(res_fn, in_dims=(None, 0, 0, 0)))        # (B, Nl, 4)
        jac_pose = vmap(vmap(jacfwd(res_fn, argnums=0), in_dims=(None, 0, 0, 0)))
        jac_point = vmap(vmap(jacfwd(res_fn, argnums=1), in_dims=(None, 0, 0, 0)))
        device = X0.device
        eye3 = torch.eye(3, device=device)
        eye6 = torch.eye(6, device=device)

        async def cost(pose6, X):
            r = residuals(pose6, X, kp_l, kp_r)
            return await psum_all(shard, torch.sum((r * r) * w[..., None], dim=(1, 2)))

        pose6, X = pose0, X0
        lam = torch.full((pose0.shape[0],), config.init_lambda, dtype=torch.float32,
                         device=device)
        c0 = current_cost = await cost(pose0, X0)
        for _ in range(config.max_iterations):
            r = residuals(pose6, X, kp_l, kp_r)
            if config.loss == "huber":
                err = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
                rw = w * torch.sqrt(torch.clamp(config.huber_delta / err, max=1.0))
            else:
                rw = w
            r = r * rw[..., None]
            Jp = jac_pose(pose6, X, kp_l, kp_r) * rw[..., None, None]      # (B, Nl, 4, 6)
            Jx = jac_point(pose6, X, kp_l, kp_r) * rw[..., None, None]     # (B, Nl, 4, 3)

            Bm = torch.einsum("bnri,bnrj->bij", Jp, Jp)
            E = torch.einsum("bnri,bnrj->bnij", Jp, Jx)
            C = torch.einsum("bnri,bnrj->bnij", Jx, Jx)
            v = -torch.einsum("bnri,bnr->bi", Jp, r)
            g = -torch.einsum("bnri,bnr->bni", Jx, r)

            C_inv = small_linalg.inv3(C + lam[:, None, None, None] * eye3)
            EC = E @ C_inv
            S_local = Bm - torch.einsum("bnij,bnkj->bik", EC, E)
            rhs_local = v - torch.einsum("bnij,bnj->bi", EC, g)
            # the one collective of the step: S and rhs packed, (B, 42)
            packed = await psum_all(
                shard, torch.cat([S_local.reshape(-1, 36), rhs_local], dim=1))
            S = packed[:, :36].reshape(-1, 6, 6) + lam[:, None, None] * eye6
            d_pose = small_linalg.solve_spd_small(S, packed[:, 36:])
            d_X = torch.einsum("bnij,bnj->bni", C_inv,
                               g - torch.einsum("bnji,bj->bni", E, d_pose))

            new_pose = pose6 + d_pose
            new_X = X + d_X
            new_cost = await cost(new_pose, new_X)
            accept = new_cost < current_cost
            pose6 = torch.where(accept[:, None], new_pose, pose6)
            X = torch.where(accept[:, None, None], new_X, X)
            lam = torch.where(accept,
                              torch.clamp(lam * config.lambda_down, min=config.min_lambda),
                              torch.clamp(lam * config.lambda_up, max=config.max_lambda))
            current_cost = torch.where(accept, new_cost, current_cost)
        return pose6, X, c0, current_cost

    return local


def _run_batch(matches_left, matches_right, K_left, K_right, pose0, init_points, mesh,
               weights, config, shard_axes):
    """(pose (B, 6), points (B, N, 3), initial costs (B,), final costs (B,))."""
    b, _, n = matches_left.shape
    w = (torch.ones((b, n), device=matches_left.device) if weights is None
         else weights.to(torch.float32))
    axes = tuple(shard_axes)
    pts = (None, axes, None)
    return shard_map(
        _local_lm(config, axes), mesh,
        [pts, pts, (None, axes), pts, None, None, None],
        [(), (None, axes, None), (), ()],
        matches_left.transpose(1, 2), matches_right.transpose(1, 2), w,
        init_points.transpose(1, 2), pose0, K_left, K_right)


def distributed_bundle_adjust(
    matches_left: torch.Tensor,     # (3, N); N split over the mesh
    matches_right: torch.Tensor,
    K_left: torch.Tensor,
    K_right: torch.Tensor,
    init_rotation: torch.Tensor,
    init_translation: torch.Tensor,
    init_points: torch.Tensor,      # (3, N)
    mesh,
    weights=None,                   # (N,)
    config: BundleAdjustmentConfig = BundleAdjustmentConfig(),
    shard_axes: tuple = ("data", "tile"),
) -> BAResult:
    """``bundle_adjust`` with the points split over ``shard_axes`` (N must
    divide into the mesh's shards along them)."""
    pose0 = torch.cat([geo.rotation_to_angle_axis(init_rotation), init_translation])
    pose_f, X_f, c0, cost_f = _run_batch(
        matches_left[None], matches_right[None], K_left, K_right, pose0[None],
        init_points[None], mesh, None if weights is None else weights[None], config,
        shard_axes)
    R = geo.angle_axis_to_rotation(pose_f[0, :3])
    T = pose_f[0, 3:]
    F = geo.fundamental_from_essential(geo.essential_from_pose(R, T), K_left, K_right)
    return BAResult(rotation=R, translation=T, pose=pose_matrix(R, T), points=X_f[0].T,
                    initial_cost=c0[0], final_cost=cost_f[0], fundamental=F)


def distributed_bundle_adjust_batch(
    matches_left: torch.Tensor,       # (B, 3, N); N split over the mesh
    matches_right: torch.Tensor,
    K_left: torch.Tensor,
    K_right: torch.Tensor,
    init_rotations: torch.Tensor,     # (B, 3, 3)
    init_translations: torch.Tensor,  # (B, 3)
    init_points: torch.Tensor,        # (B, 3, N)
    mesh,
    weights=None,                     # (B, N)
    config: BundleAdjustmentConfig = BundleAdjustmentConfig(),
    shard_axes: tuple = ("data", "tile"),
):
    """B independent two-view BAs as one distributed LM: per iteration all
    B Schur systems ride one (B, 42) ``psum`` and the costs one (B,).

    Returns (poses (B, 4, 4), fundamentals (B, 3, 3), initial_costs (B,),
    final_costs (B,), points (B, 3, N))."""
    pose0 = torch.cat([geo.rotation_to_angle_axis(init_rotations), init_translations],
                      dim=-1)
    pose_f, X_f, c0, cost_f = _run_batch(
        matches_left, matches_right, K_left, K_right, pose0, init_points, mesh, weights,
        config, shard_axes)
    R = geo.angle_axis_to_rotation(pose_f[:, :3])
    T = pose_f[:, 3:]
    F = geo.fundamental_from_essential(geo.essential_from_pose(R, T), K_left, K_right)
    return pose_matrix(R, T), F, c0, cost_f, X_f.transpose(1, 2)
