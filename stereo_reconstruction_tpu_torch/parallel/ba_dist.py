"""Distributed Schur-complement bundle adjustment.

Port of ``stereo_reconstruction_tpu/parallel/ba_dist.py``: the two-view
LM of ``pose/ba.py`` with the 3D points split over the mesh. Each shard
eliminates its own point blocks; the reduced 6x6 camera system (S, rhs),
42 floats, is ``psum``-ed across the mesh in one packed collective per LM
iteration, and the costs of the accept test in one more. The pose update
is computed on every shard alike, the point back-substitution stays
local. The batched form advances B independent problems in lockstep and
reduces their systems as one (B, 42) ``psum``; each problem's own
arithmetic is that of a batch of one, so each gives the same bits as
``distributed_bundle_adjust`` on it alone (JAX: the same semantics).
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
    """The per-shard body: B problems (leading axis) of the shard's points.

    Each problem's arithmetic runs on its own slice and only the
    collectives take the batch, so that a problem's result does not depend
    on the batch it rides in: on the card a batched product or reduction
    may round apart from a single one, and the pose's translation and the
    points share a scale that no residual sees, along which the damped
    solve carries such a difference on (~1e4 times)."""

    async def psum_all(shard, x):
        for ax in shard_axes:
            x = await shard.psum(x, ax)
        return x

    async def local(shard, kp_l, kp_r, w, X0, pose0, K_left, K_right):
        # kp_l, kp_r, X0 (B, Nl, 3), w (B, Nl), pose0 (B, 6)
        def res_fn(pose6, X, kl, kr):
            return _residuals_one(pose6, X, kl, kr, K_left, K_right)

        residuals = vmap(vmap(res_fn, in_dims=(None, 0, 0, 0)))        # (1, Nl, 4)
        jac_pose = vmap(vmap(jacfwd(res_fn, argnums=0), in_dims=(None, 0, 0, 0)))
        jac_point = vmap(vmap(jacfwd(res_fn, argnums=1), in_dims=(None, 0, 0, 0)))
        device = X0.device
        eye3 = torch.eye(3, device=device)
        eye6 = torch.eye(6, device=device)
        pairs = range(pose0.shape[0])
        # problem b's observations, each (1, ...)
        kl = [kp_l[b:b + 1] for b in pairs]
        kr = [kp_r[b:b + 1] for b in pairs]
        wb = [w[b:b + 1] for b in pairs]

        async def costs(poses, Xs):
            parts = []
            for b in pairs:
                r = residuals(poses[b], Xs[b], kl[b], kr[b])
                parts.append(torch.sum((r * r) * wb[b][..., None], dim=(1, 2)))
            total = await psum_all(shard, torch.cat(parts))
            return [total[b:b + 1] for b in pairs]

        def schur(b, pose6, X, lam):
            """Problem b's damped point blocks eliminated: (C_inv, E, g) and
            its local (1, 42) camera system, S and rhs packed."""
            r = residuals(pose6, X, kl[b], kr[b])
            if config.loss == "huber":
                err = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
                rw = wb[b] * torch.sqrt(torch.clamp(config.huber_delta / err, max=1.0))
            else:
                rw = wb[b]
            r = r * rw[..., None]
            Jp = jac_pose(pose6, X, kl[b], kr[b]) * rw[..., None, None]      # (1, Nl, 4, 6)
            Jx = jac_point(pose6, X, kl[b], kr[b]) * rw[..., None, None]     # (1, Nl, 4, 3)

            Bm = torch.einsum("bnri,bnrj->bij", Jp, Jp)
            E = torch.einsum("bnri,bnrj->bnij", Jp, Jx)
            C = torch.einsum("bnri,bnrj->bnij", Jx, Jx)
            v = -torch.einsum("bnri,bnr->bi", Jp, r)
            g = -torch.einsum("bnri,bnr->bni", Jx, r)

            C_inv = small_linalg.inv3(C + lam[:, None, None, None] * eye3)
            EC = E @ C_inv
            S_local = Bm - torch.einsum("bnij,bnkj->bik", EC, E)
            rhs_local = v - torch.einsum("bnij,bnj->bi", EC, g)
            return (C_inv, E, g), torch.cat([S_local.reshape(-1, 36), rhs_local], dim=1)

        poses = [pose0[b:b + 1] for b in pairs]
        Xs = [X0[b:b + 1] for b in pairs]
        lams = [torch.full((1,), config.init_lambda, dtype=torch.float32, device=device)
                for _ in pairs]
        c0 = await costs(poses, Xs)
        current = list(c0)
        for _ in range(config.max_iterations):
            blocks, systems = zip(*(schur(b, poses[b], Xs[b], lams[b]) for b in pairs))
            # the one collective of the step: every problem's S and rhs, (B, 42)
            packed = await psum_all(shard, torch.cat(systems))
            new_poses, new_Xs = [], []
            for b in pairs:
                C_inv, E, g = blocks[b]
                S = packed[b:b + 1, :36].reshape(-1, 6, 6) + lams[b][:, None, None] * eye6
                d_pose = small_linalg.solve_spd_small(S, packed[b:b + 1, 36:])
                d_X = torch.einsum("bnij,bnj->bni", C_inv,
                                   g - torch.einsum("bnji,bj->bni", E, d_pose))
                new_poses.append(poses[b] + d_pose)
                new_Xs.append(Xs[b] + d_X)
            new = await costs(new_poses, new_Xs)
            for b in pairs:
                accept = new[b] < current[b]
                poses[b] = torch.where(accept[:, None], new_poses[b], poses[b])
                Xs[b] = torch.where(accept[:, None, None], new_Xs[b], Xs[b])
                lams[b] = torch.where(
                    accept, torch.clamp(lams[b] * config.lambda_down, min=config.min_lambda),
                    torch.clamp(lams[b] * config.lambda_up, max=config.max_lambda))
                current[b] = torch.where(accept, new[b], current[b])
        return torch.cat(poses), torch.cat(Xs), torch.cat(c0), torch.cat(current)

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
