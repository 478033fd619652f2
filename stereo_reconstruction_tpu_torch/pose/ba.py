"""Two-view bundle adjustment: Levenberg-Marquardt with a Schur complement.

Port of ``stereo_reconstruction_tpu/pose/ba.py`` (the reference's Ceres
solve, ``src/PoseEstimation/bundle_adjustment.h:205-272``): a 6-DoF pose
(angle-axis + translation) and N 3D points; four residuals per point
(left and right reprojection, observed - projected); per-point Jacobian
blocks by forward-mode autodiff (``torch.func.vmap(torch.func.jacfwd)``);
Huber IRLS weights; the 3x3 point blocks eliminated by closed-form
inverses and the 6x6 camera system solved by an unrolled Cholesky. The
``max_iterations`` LM steps accept or reject with ``torch.where``, so the
loop never waits on the device. ``converged`` says whether the cost
settled over the last ``SETTLE_WINDOW`` steps; from a start a few degrees
off, LM alternates accepted and rejected steps and can still be descending
after 20 (``pose.pipeline.settle_pose`` continues it there).

On the card the whole solve is the hand-written kernel (``csrc/ba.cuh``,
launched by ``ops/cuda_ba.py``): one launch for every start of a problem
(``bundle_adjust_starts``), a batch's under ``torch.func.vmap`` too, in
place of the ~21,800 small ops of ``bundle_adjust_plain``, its plain twin,
which CPU tensors take. Nothing falls back: a CUDA input the kernel does
not take raises, and ``pose.pipeline.check_kernel_config`` lets a caller
raise before SIFT.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from stereo_reconstruction_tpu_torch.config import BundleAdjustmentConfig
from stereo_reconstruction_tpu_torch.kernels.launch import on_card
from stereo_reconstruction_tpu_torch.ops import cuda_ba, geometry as geo
from stereo_reconstruction_tpu_torch.ops import small_linalg
from stereo_reconstruction_tpu_torch.pose.eight_point import pose_matrix


class BAResult(NamedTuple):
    rotation: torch.Tensor       # (3, 3)
    translation: torch.Tensor    # (3,)
    pose: torch.Tensor           # (4, 4)
    points: torch.Tensor         # (3, N) optimised 3D points (left frame)
    initial_cost: torch.Tensor   # () weighted sum of squared residuals at start
    final_cost: torch.Tensor     # ()
    fundamental: torch.Tensor    # (3, 3) F from the optimised pose
    converged: Optional[torch.Tensor] = None   # () bool: the cost settled


# LM has converged when its last SETTLE_WINDOW steps lowered the cost by at
# most SETTLE_RTOL of it: at 750x900, runs from good starts end below 4e-5,
# runs still descending from starts 2-3 degrees off take 4e-2 to 2e-1 a step
SETTLE_WINDOW = 3
SETTLE_RTOL = 1e-3


def _residuals_one(pose6, X, kp_left, kp_right, K_left, K_right):
    """(4,) residuals of one point, [left_x, left_y, right_x, right_y]
    (BundleAdjustmentConstraint::operator(), bundle_adjustment.h:134-161)."""
    pl = K_left @ X
    pl = pl / pl[2]
    R = geo.angle_axis_to_rotation(pose6[:3])
    pr = K_right @ (R @ X + pose6[3:])
    pr = pr / pr[2]
    return torch.cat([kp_left[:2] - pl[:2], kp_right[:2] - pr[:2]])


def bundle_adjust(
    matches_left: torch.Tensor,      # (3, N) homogeneous pixels
    matches_right: torch.Tensor,     # (3, N)
    K_left: torch.Tensor,
    K_right: torch.Tensor,
    init_rotation: torch.Tensor,     # (3, 3)
    init_translation: torch.Tensor,  # (3,)
    init_points: torch.Tensor,       # (3, N) initial 3D points (left frame)
    weights: Optional[torch.Tensor] = None,   # (N,) 0/1 mask of real points
    config: BundleAdjustmentConfig = BundleAdjustmentConfig(),
) -> BAResult:
    """Tensors on one CUDA device: the kernel (``ops/cuda_ba.py``, one
    launch); on the CPU: ``bundle_adjust_plain``."""
    return bundle_adjust_starts(matches_left, matches_right, K_left, K_right,
                                init_rotation[None], init_translation[None], init_points[None],
                                weights, config)[0]


def bundle_adjust_starts(matches_left, matches_right, K_left, K_right,
                         init_rotations: torch.Tensor,     # (S, 3, 3)
                         init_translations: torch.Tensor,  # (S, 3)
                         init_points: torch.Tensor,        # (S, 3, N)
                         weights: Optional[torch.Tensor] = None,
                         config: BundleAdjustmentConfig = BundleAdjustmentConfig(),
                         ) -> List[BAResult]:
    """``bundle_adjust`` of one problem from each of S starts: on one CUDA
    device one launch for all of them (a batch's under ``torch.func.vmap``
    too); on the CPU ``bundle_adjust_plain`` from each in turn."""
    card = on_card("ba", matches_left, matches_right, K_left, K_right, init_rotations,
                   init_translations, init_points, weights)
    starts = init_rotations.shape[0]
    if not card:
        return [bundle_adjust_plain(matches_left, matches_right, K_left, K_right,
                                    init_rotations[s], init_translations[s], init_points[s],
                                    weights, config) for s in range(starts)]
    n = matches_left.shape[-1]
    w = (torch.ones(n, device=matches_left.device) if weights is None
         else weights.to(torch.float32))
    out = cuda_ba.bundle_adjust_op(
        matches_left, matches_right, K_left, K_right, w, init_rotations, init_translations,
        init_points, config.max_iterations, config.loss, float(config.huber_delta),
        float(config.init_lambda), float(config.lambda_up), float(config.lambda_down),
        float(config.min_lambda), float(config.max_lambda), SETTLE_WINDOW, SETTLE_RTOL)
    return [BAResult(*(x[s] for x in out)) for s in range(starts)]


def bundle_adjust_plain(
    matches_left: torch.Tensor,      # (3, N) homogeneous pixels
    matches_right: torch.Tensor,     # (3, N)
    K_left: torch.Tensor,
    K_right: torch.Tensor,
    init_rotation: torch.Tensor,     # (3, 3)
    init_translation: torch.Tensor,  # (3,)
    init_points: torch.Tensor,       # (3, N) initial 3D points (left frame)
    weights: Optional[torch.Tensor] = None,   # (N,) 0/1 mask of real points
    config: BundleAdjustmentConfig = BundleAdjustmentConfig(),
) -> BAResult:
    """The kernel's plain twin, on the inputs' device: ``max_iterations``
    LM steps from the start, with no host sync."""
    device = matches_left.device
    n = matches_left.shape[-1]
    w = (torch.ones(n, device=device) if weights is None
         else weights.to(torch.float32))
    kp_l = matches_left.T            # (N, 3)
    kp_r = matches_right.T
    X0 = init_points.T               # (N, 3)
    pose0 = torch.cat([geo.rotation_to_angle_axis(init_rotation), init_translation])

    def res_fn(pose6, X, kl, kr):
        return _residuals_one(pose6, X, kl, kr, K_left, K_right)

    residuals_all = vmap(res_fn, in_dims=(None, 0, 0, 0))          # (N, 4)
    jac_pose = vmap(jacfwd(res_fn, argnums=0), in_dims=(None, 0, 0, 0))   # (N, 4, 6)
    jac_point = vmap(jacfwd(res_fn, argnums=1), in_dims=(None, 0, 0, 0))  # (N, 4, 3)

    def cost(pose6, X):
        r = residuals_all(pose6, X, kp_l, kp_r)
        return torch.sum((r * r) * w[:, None])

    eye3 = torch.eye(3, device=device)
    eye6 = torch.eye(6, device=device)
    pose6, X = pose0, X0
    lam = torch.full((), config.init_lambda, dtype=torch.float32, device=device)
    c0 = current_cost = cost(pose0, X0)
    history = [c0]
    for _ in range(config.max_iterations):
        r = residuals_all(pose6, X, kp_l, kp_r)
        # IRLS weights: 1 for L2; Huber clip beyond delta px per point
        if config.loss == "huber":
            err = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
            rw = w * torch.sqrt(torch.clamp(config.huber_delta / err, max=1.0))
        else:
            rw = w
        r = r * rw[:, None]
        Jp = jac_pose(pose6, X, kp_l, kp_r) * rw[:, None, None]
        Jx = jac_point(pose6, X, kp_l, kp_r) * rw[:, None, None]

        # normal equations of residual = obs - pred: J^T J d = -J^T r
        B = torch.einsum("nri,nrj->ij", Jp, Jp)               # (6, 6)
        E = torch.einsum("nri,nrj->nij", Jp, Jx)              # (N, 6, 3)
        C = torch.einsum("nri,nrj->nij", Jx, Jx)              # (N, 3, 3)
        v = -torch.einsum("nri,nr->i", Jp, r)                 # (6,)
        g = -torch.einsum("nri,nr->ni", Jx, r)                # (N, 3)

        C_inv = small_linalg.inv3(C + (lam * eye3)[None])
        EC = E @ C_inv                                        # (N, 6, 3)
        S = B + lam * eye6 - torch.einsum("nij,nkj->ik", EC, E)
        rhs = v - torch.einsum("nij,nj->i", EC, g)
        d_pose = small_linalg.solve_spd_small(S, rhs)
        d_X = torch.einsum("nij,nj->ni", C_inv,
                           g - torch.einsum("nji,j->ni", E, d_pose))

        new_pose = pose6 + d_pose
        new_X = X + d_X
        new_cost = cost(new_pose, new_X)
        accept = new_cost < current_cost
        pose6 = torch.where(accept, new_pose, pose6)
        X = torch.where(accept, new_X, X)
        lam = torch.where(accept,
                          torch.clamp(lam * config.lambda_down, min=config.min_lambda),
                          torch.clamp(lam * config.lambda_up, max=config.max_lambda))
        current_cost = torch.where(accept, new_cost, current_cost)
        history.append(current_cost)

    before = history[max(len(history) - 1 - SETTLE_WINDOW, 0)]
    R = geo.angle_axis_to_rotation(pose6[:3])
    T = pose6[3:]
    F = geo.fundamental_from_essential(geo.essential_from_pose(R, T), K_left, K_right)
    return BAResult(rotation=R, translation=T, pose=pose_matrix(R, T), points=X.T,
                    initial_cost=c0, final_cost=current_cost, fundamental=F,
                    converged=before - current_cost <= SETTLE_RTOL * before)
