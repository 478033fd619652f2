"""End-to-end stereo reconstruction.

Port of ``stereo_reconstruction_tpu/pipeline.py`` (``estimate_pose``,
``run_pair``, ``reconstruct_from_disparity``; reference ``main()``,
``src/main.cpp:13-66``): sparse pose (SIFT x2 -> match -> RANSAC
eight-point -> BA) -> Loop-Zhang rectification -> dense Right-variant
disparity -> nearest-neighbour back-warp -> outlier clamp -> depth ->
back-projection -> mesh, plus ``evaldisp`` when ground truth is present.
``fixed_F`` skips the pose stage (the shared-pose mode). Staged
artefacts are the same as the JAX package's: ``<name>_disp.pfm``,
``<name>_pose.json`` and ``<name>_mesh.off``.

The entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU; without a card they raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from stereo_reconstruction_tpu_torch.config import PipelineConfig
from stereo_reconstruction_tpu_torch.data.records import StereoPair
from stereo_reconstruction_tpu_torch.io.image import disparity_png_roundtrip
from stereo_reconstruction_tpu_torch.io.pfm import write_pfm
from stereo_reconstruction_tpu_torch.ops import metrics as metrics_mod
from stereo_reconstruction_tpu_torch.ops.block_search import block_search_right
from stereo_reconstruction_tpu_torch.ops.features import Keypoints, detect_and_describe_batch
from stereo_reconstruction_tpu_torch.ops.matching import match_descriptors, valid_first
from stereo_reconstruction_tpu_torch.perceptual import perceptual_window_search, vgg_module
from stereo_reconstruction_tpu_torch.pose.pipeline import (
    PoseEstimate,
    estimate_pose_from_matches,
    settle_pose,
)
from stereo_reconstruction_tpu_torch.pose.graphs import pose_graphs
from stereo_reconstruction_tpu_torch.pose.ransac import check_kernel_config, draw_uniforms
from stereo_reconstruction_tpu_torch.recon.backproject import backproject
from stereo_reconstruction_tpu_torch.recon.disparity import (
    disparity_to_depth,
    remove_disparity_outliers,
)
from stereo_reconstruction_tpu_torch.recon.meshing import save_mesh
from stereo_reconstruction_tpu_torch.rectify.rectifier import (
    disparity_to_original_frame,
    rectify_pair,
)
from stereo_reconstruction_tpu_torch.utils.profiling import StageTimer, span


@dataclasses.dataclass
class PipelineResult:
    pose: Optional[PoseEstimate]
    disparity: np.ndarray            # (H, W) right-image disparity, original frame
    depth: Optional[np.ndarray]
    metrics: Dict[str, float]
    timings: Dict[str, float]


def _device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no CPU
    fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available; "
                           "pass device='cpu' to run on the CPU")
    return device


def pose_from_keypoints(kp_left: Keypoints, kp_right: Keypoints, K_left: torch.Tensor,
                        K_right: torch.Tensor, uniforms: torch.Tensor,
                        config: PipelineConfig) -> PoseEstimate:
    """Match -> valid matches to the front -> RANSAC eight-point -> filter
    -> one BA round for one pair's keypoints, on their device with no host
    sync and no data-dependent Python branch, so ``torch.func.vmap``
    batches it (``pipeline_batch.pose_batch``); its caller settles BA
    (``pose/pipeline.py::settle_pose``)."""
    with span("pose.match"):
        ml, mr, n_valid = valid_first(match_descriptors(kp_left, kp_right, config.frontend))
    return estimate_pose_from_matches(ml, mr, K_left, K_right, config,
                                      num_matches_valid=n_valid, uniforms=uniforms)


def pose_device(images: torch.Tensor, K_left: torch.Tensor, K_right: torch.Tensor,
                uniforms: torch.Tensor, config: PipelineConfig) -> PoseEstimate:
    """The sparse pose stage of one pair on device tensors (JAX
    ``pipeline._pose_device``): ``images`` (2, H, W, 3) left and right,
    the (3, 3) intrinsics and the (num_hypotheses, max_keypoints) RANSAC
    draws. SIFT x2 runs as one batch of two images; BA runs up to
    ``BA_ROUNDS`` rounds while it has not converged (JAX: one;
    ``pose/pipeline.py::settle_pose``). On the card the stages after SIFT
    replay CUDA graphs (``pose/graphs.py``), with the same result."""
    check_kernel_config(config.ransac, config.frontend.max_keypoints, images.device)
    with span("pose.features"):
        kp = detect_and_describe_batch(images, config.frontend)
    if images.device.type == "cuda":
        graphs = pose_graphs(kp, K_left, K_right, uniforms, config)
        return settle_pose(graphs(kp, K_left, K_right, uniforms), K_left, K_right, config,
                           step=graphs.step)
    est = pose_from_keypoints(Keypoints(*(x[0] for x in kp)),
                              Keypoints(*(x[1] for x in kp)),
                              K_left, K_right, uniforms, config)
    return settle_pose(est, K_left, K_right, config)


def estimate_pose(pair: StereoPair, config: PipelineConfig = PipelineConfig(),
                  device="cuda", uniforms: Optional[torch.Tensor] = None) -> PoseEstimate:
    """SIFT x2 -> match -> RANSAC eight-point -> filter -> BA on ``device``
    (reference runFullPoseEstimation, pose_estimation.cpp:4-115).

    ``uniforms`` are the RANSAC draws (``pose/ransac.py``); by default they
    come from a CPU generator seeded with ``config.seed``, so every device
    tries the same hypotheses. Everything after that runs on ``device``."""
    device = _device(device)
    if uniforms is None:
        uniforms = draw_uniforms(config.ransac, config.frontend.max_keypoints,
                                 torch.Generator().manual_seed(config.seed))

    def intrinsics(K):
        return torch.as_tensor(np.asarray(K), dtype=torch.float32, device=device)

    with span("pose.upload"):
        images = torch.stack([torch.as_tensor(np.asarray(pair.image_left)),
                              torch.as_tensor(np.asarray(pair.image_right))]).to(device)
        K_left, K_right = intrinsics(pair.intrinsics_left), intrinsics(pair.intrinsics_right)
        uniforms = torch.as_tensor(uniforms, dtype=torch.float32).to(device)
    return pose_device(images, K_left, K_right, uniforms, config)


def compute_disparity(left, right, config: PipelineConfig) -> torch.Tensor:
    """Dense right-image disparity on a rectified pair, on the device of the
    images, dispatched on ``config.matcher.cost``: the window-search matcher
    (ssd / sad / ncc, reference BlockSearch.cpp:88-179) or the perceptual
    LPIPS search (reference notebook cells 6-10, BASELINE config 3) with
    ``config.matcher.max_disparity`` and the VGG weights of
    ``config.perceptual.weights_path`` (the seeded He-init ones without)."""
    with span("compute_disparity"):
        if config.matcher.cost == "perceptual":
            pcfg = dataclasses.replace(config.perceptual,
                                       max_disparity=config.matcher.max_disparity)
            module = vgg_module(pcfg.weights_path, seed=config.seed, device=right.device)
            return perceptual_window_search(module, left, right, pcfg)
        return block_search_right(left, right, config.matcher)


def _reconstruct(pair: StereoPair, disparity: torch.Tensor,
                 config: PipelineConfig, device: torch.device):
    """Outlier clamp -> depth -> back-projection (reference main.cpp:53-62)."""
    disp_clean = remove_disparity_outliers(
        disparity,
        config.recon.outlier_kernel,
        config.recon.outlier_front,
        config.recon.outlier_back,
    )
    focal = float(np.asarray(pair.intrinsics_right)[0, 0])
    depth = disparity_to_depth(disp_clean, focal, config.recon.baseline)
    with span("recon.upload"):
        image = torch.as_tensor(np.asarray(pair.image_right), device=device)
        K = torch.as_tensor(np.asarray(pair.intrinsics_right), dtype=torch.float32,
                            device=device)
    return backproject(image, depth, K), depth


def run_pair(
    pair: StereoPair,
    config: PipelineConfig = PipelineConfig(),
    output_dir: Optional[str] = None,
    write_mesh: bool = False,
    png_compat: bool = False,
    fixed_F: Optional[np.ndarray] = None,
    backwarp_compat_left: bool = False,
    device="cuda",
    uniforms: Optional[torch.Tensor] = None,
) -> PipelineResult:
    """Reconstruction of one stereo pair on ``device`` (reference main.cpp
    flow).

    ``fixed_F`` skips the pose stage and rectifies from this fundamental
    matrix (the shared-pose mode); ``uniforms`` are the RANSAC draws of the
    pose stage (see ``estimate_pose``). ``png_compat`` quantises disparity
    through uint8 like the reference (main.cpp:42,50);
    ``backwarp_compat_left`` back-warps disparity with the LEFT homography
    like the reference (rectification.cpp:78-88)."""
    device = _device(device)
    timer = StageTimer()
    with span("run_pair"):
        pose = None
        with timer.stage("pose", device if fixed_F is None else None):
            if fixed_F is None:
                pose = estimate_pose(pair, config, device, uniforms)

        # a degenerate pose (cheirality failure, non-finite or huge reprojection
        # error) would rectify into garbage: match the raw pair instead
        # (pose_estimation.cpp:84 throws there)
        pose_ok = fixed_F is not None or (
            bool(pose.valid) and float(pose.reproj_error_ba) < 50.0)

        F = np.eye(3)
        with timer.stage("rectify", device if pose_ok else None):
            if pose_ok:
                F = (np.asarray(fixed_F, np.float64) if fixed_F is not None
                     else pose.fundamental.cpu().numpy().astype(np.float64))
                with span("rectify.upload"):
                    left = torch.as_tensor(np.asarray(pair.image_left), device=device)
                    right = torch.as_tensor(np.asarray(pair.image_right), device=device)
                rect = rectify_pair(left, right, F, config=config.rectify)

        with timer.stage("disparity", device):
            if pose_ok:
                disp_rect = compute_disparity(rect.left, rect.right, config)
                disparity = disparity_to_original_frame(
                    disp_rect,
                    rect.homographies.H_right,
                    (pair.height, pair.width),
                    compat_left_homography=(rect.homographies.H_left
                                            if backwarp_compat_left else None),
                )
            else:
                disparity = compute_disparity(
                    torch.as_tensor(np.asarray(pair.image_left), dtype=torch.float32,
                                    device=device),
                    torch.as_tensor(np.asarray(pair.image_right), dtype=torch.float32,
                                    device=device),
                    config,
                )

        with span("entry.download"):
            disparity_np = disparity.cpu().numpy()
        if png_compat:
            disparity_np = disparity_png_roundtrip(disparity_np)

        with timer.stage("recon", device):
            with span("recon.upload"):
                disparity_dev = torch.as_tensor(disparity_np, device=device)
            grid, depth = _reconstruct(pair, disparity_dev, config, device)
        timings = timer.timings

        results: Dict[str, float] = {"pose_ok": float(pose_ok)}
        if pose is not None:
            results.update({
                "reproj_error_8pt": float(pose.reproj_error_8pt),
                "reproj_error_ba": float(pose.reproj_error_ba),
                "num_inliers": int(pose.num_inliers),
            })
        if pair.disp_right_gt is not None and pair.mask_right_nocc is not None:
            m = metrics_mod.evaldisp(
                torch.as_tensor(disparity_np, device=device),
                torch.as_tensor(np.asarray(pair.disp_right_gt), device=device),
                torch.as_tensor(np.asarray(pair.mask_right_nocc), device=device),
                bad_thresh=2.0,
                max_disp=float(pair.ndisp or 1e9),
            )
            results.update({k: float(v) for k, v in m.items()})

        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            stem = os.path.join(output_dir, pair.name or "pair")
            write_pfm(stem + "_disp.pfm", disparity_np.astype(np.float32))
            with open(stem + "_pose.json", "w") as f:
                json.dump(
                    {
                        "pose": (pose.pose.cpu().numpy().tolist()
                                 if pose is not None else None),
                        "fundamental": F.tolist(),
                        "metrics": results,
                        "timings": timings,
                    },
                    f,
                    indent=2,
                )
            if write_mesh:
                save_mesh(stem + "_mesh.off", grid, config.recon.mesh_edge_threshold)

        with span("entry.download"):
            depth_np = depth.cpu().numpy()
        return PipelineResult(
            pose=pose,
            disparity=disparity_np,
            depth=depth_np,
            metrics=results,
            timings=timings,
        )


def reconstruct_from_disparity(
    pair: StereoPair,
    disparity: np.ndarray,
    config: PipelineConfig = PipelineConfig(),
    output_path: Optional[str] = None,
    device="cuda",
):
    """Reconstruct from a precomputed disparity map (the reference's
    RUN_ALL=0 path, main.cpp:11,46-65): (vertex grid, depth)."""
    device = _device(device)
    grid, depth = _reconstruct(
        pair, torch.as_tensor(np.asarray(disparity), device=device), config, device)
    if output_path:
        save_mesh(output_path, grid, config.recon.mesh_edge_threshold)
    return grid, depth.cpu().numpy()
