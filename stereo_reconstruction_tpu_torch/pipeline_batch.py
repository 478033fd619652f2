"""Batched end-to-end pipeline: B pairs through one batched pose stage,
host Loop-Zhang, and one batched dense stage.

Port of ``stereo_reconstruction_tpu/pipeline_batch.py`` (``run_batch``,
``run_batches``; reference ``main()``, ``src/main.cpp:13-66``, batched):

  pose, on the device:   SIFT over all 2B images as one batch, then
                         matching -> RANSAC eight-point -> BA for the B
                         pairs under ``torch.func.vmap`` (JAX vmaps the
                         whole per-pair program, ``_pose_batch``); at the
                         sync point BA is continued where a pair's has not
                         converged (``settle_pose``; JAX: one round);
  host:                  Loop-Zhang homographies per pair (3x3 float64);
  dense, on the device:  the two warps onto the static canvas (the warp
                         kernel, one launch for up to 32 of the batch's 2B
                         images, the inverse maps made on the host), the matcher
                         (one K1 and one K1b launch per pair), the
                         nearest-neighbour back-warp, the outlier clamp and
                         depth over the batch; ``evaldisp`` over the pairs
                         with GT in one batched call.

The padding is part of the result, as in JAX: the batch is padded to
``hmax`` rounded up to a multiple of 8 and ``wmax`` to a multiple of 128;
the pose stage sees the padded images, the canvas is that of the padded
shape, and Loop-Zhang gets each pair's true shape. Disparities come back
as exact int16 (``rint``), depth only on request.

Failure masking: ``pose_ok = valid & (reproj_error_ba < 50)``, and a
Loop-Zhang exception fails its pair; a failed pair is warped with identity
homographies inside the same dense stage (a zero-padded copy of the raw
pair, which MiddEval3 pairs make meaningful, being row-aligned).

The TPU workarounds of the JAX module are left out (its upload dtype
diet, the band warps and their sticky classes); the outputs keep their
dtypes. The RANSAC draws are an input: JAX folds one threefry key per
pair, which torch cannot reproduce, so pair ``i`` of batch ``b`` draws
from a CPU generator seeded by ``batch_uniforms`` (``config.seed``, ``b``,
``i``), and a CPU run and a card run try the same hypotheses.

On CUDA every stage is asynchronous up to its first host read, BA's
convergence flags being the sync point (the pose outputs' ``np.asarray``
in JAX); ``run_batches``
orders the stages so batch i+1's upload and pose are queued before batch
i's host geometry waits.

Spans (``utils/profiling.py::span``, recorded under a profiler session,
with the names ``run_pair`` uses): ``run_batch`` around the call;
``batch.upload``, the pinned uploads; ``pose`` from the first shard's
dispatch to the host reads of its settled pose (``pose.features`` around
the detector batch, the pose stage's own ``pose.match``, ``pose.ransac``
and ``pose.ba`` under it), and one more ``pose`` for each later shard's
wait; ``rectify.homographies``, host Loop-Zhang and the canvas; ``dense``
from the warps (``rectify.warp``) and the matcher (``disparity``) through
the downloads (``entry.download``), the last shard's running on through
every shard's downloads. None adds a host sync.

``mesh=``, a one-process ``parallel.mesh.Mesh``, splits the batch over its
``data`` axis, as JAX shards the images, intrinsics and keys with
``P("data", ...)``: data shard i takes the i-th run of B / data pairs, on
the device of mesh shard (i, 0) (``Mesh.data_blocks``), with its slice of
the draws. Every shard is padded to the whole batch's (hmax, wmax), so it
computes what ``run_batch`` of its pairs alone, padded to that shape and
with those draws, computes, bit for bit; against the unsharded batch the
result moves only as far as BA's batched solves round apart at another B.
Every shard's pose is queued before the host waits on the first, and the
host geometry, the dense stage and the downloads then go shard by shard in
data order. A multi-process mesh (``multihost.ProcessGroupMesh``) is
refused: the host Loop-Zhang stage reads every pair's F, which one process
of a process group does not hold, and JAX has no such path either.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from stereo_reconstruction_tpu_torch.config import PipelineConfig
from stereo_reconstruction_tpu_torch.data.records import StereoPair, pad_to
from stereo_reconstruction_tpu_torch.ops import metrics as metrics_mod
from stereo_reconstruction_tpu_torch.ops.features import Keypoints, detect_and_describe_batch
from stereo_reconstruction_tpu_torch.ops.warp import host_inverse, warp_perspective
from stereo_reconstruction_tpu_torch.parallel.mesh import Mesh
from stereo_reconstruction_tpu_torch.parallel.multihost import ProcessGroupMesh
from stereo_reconstruction_tpu_torch.pipeline import _device, compute_disparity, \
    pose_from_keypoints
from stereo_reconstruction_tpu_torch.pose.pipeline import PoseEstimate, check_kernel_config, \
    settle_pose
from stereo_reconstruction_tpu_torch.pose.ransac import draw_uniforms
from stereo_reconstruction_tpu_torch.recon.disparity import (
    disparity_to_depth,
    remove_disparity_outliers,
)
from stereo_reconstruction_tpu_torch.rectify.loop_zhang import loop_zhang_homographies
from stereo_reconstruction_tpu_torch.rectify.rectifier import static_canvas
from stereo_reconstruction_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class BatchResult:
    disparity: np.ndarray          # (B, H, W) original-frame right disparity, padded
    depth: Optional[np.ndarray]    # (B, H, W); None when fetch_depth=False
    pose: PoseEstimate             # every field with a leading B dimension
    pose_ok: np.ndarray            # (B,) bool: the pose was used to rectify
    metrics: List[Dict[str, float]]
    timings: Dict[str, float]


def batch_uniforms(config: PipelineConfig, batch_size: int,
                   batch_index: int = 0) -> torch.Tensor:
    """The default RANSAC draws of a batch, (B, num_hypotheses,
    max_keypoints) float32 on the CPU: pair ``i`` of batch ``b`` takes
    ``draw_uniforms`` from ``torch.Generator().manual_seed(s)``, where
    ``s`` is the first 64-bit word of
    ``numpy.random.SeedSequence((config.seed, b, i))``."""
    out = []
    for i in range(batch_size):
        seed = np.random.SeedSequence((config.seed, batch_index, i)).generate_state(
            1, np.uint64)[0]
        out.append(draw_uniforms(config.ransac, config.frontend.max_keypoints,
                                 torch.Generator().manual_seed(int(seed))))
    return torch.stack(out)


def pose_batch(left: torch.Tensor, right: torch.Tensor, K_left: torch.Tensor,
               K_right: torch.Tensor, uniforms: torch.Tensor,
               config: PipelineConfig) -> PoseEstimate:
    """The sparse pose stage of B pairs, (B, H, W, 3) images, (B, 3, 3)
    intrinsics and (B, num_hypotheses, max_keypoints) draws on one device:
    ``_pose_dispatch``, then BA settled over the batch (``settle_pose``),
    so each pair's pose is ``pipeline.pose_device``'s."""
    return settle_pose(_pose_dispatch(left, right, K_left, K_right, uniforms, config),
                       K_left, K_right, config)


def _pose_dispatch(left, right, K_left, K_right, uniforms, config) -> PoseEstimate:
    """One detector batch of 2B images, then ``pipeline.pose_from_keypoints``
    under ``torch.func.vmap``: queued with no host sync."""
    B = left.shape[0]
    check_kernel_config(config, left.device)
    with span("pose.features"):
        kp = detect_and_describe_batch(torch.cat([left, right]), config.frontend)
    kp_l = Keypoints(*(x[:B] for x in kp))
    kp_r = Keypoints(*(x[B:] for x in kp))
    return vmap(lambda kl, kr, a, b, u: pose_from_keypoints(kl, kr, a, b, u, config))(
        kp_l, kp_r, K_left, K_right, uniforms)


def _evaldisp_batch(disp, gt, mask, max_disp):
    return vmap(lambda d, g, m, x: metrics_mod.evaldisp(d, g, m, 2.0, x))(
        disp, gt, mask, max_disp)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor; on CUDA through pinned memory, so the
    copy is queued and the host does not wait for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _add(timings: Dict[str, float], key: str, seconds: float) -> None:
    """A stage's clock: the shards of a batch run each stage in turn on the
    host, so their times add up to the stage's span."""
    timings[key] = timings.get(key, 0.0) + seconds


@dataclasses.dataclass
class _Staged:
    """One shard of a batch across the dispatch and sync stages (the
    whole batch without a mesh); the shards of a batch share ``timings``."""
    pairs: Sequence[StereoPair]
    padded: list
    hmax: int
    wmax: int
    device: torch.device
    L: torch.Tensor
    R: torch.Tensor
    KL: torch.Tensor
    KR: torch.Tensor
    uniforms: torch.Tensor
    timings: Dict[str, float]
    pose: Optional[PoseEstimate] = None
    pose_ok: Optional[np.ndarray] = None
    err_ba: Optional[np.ndarray] = None
    F: Optional[np.ndarray] = None             # (B, 3, 3) float64 on the host
    Hl: Optional[np.ndarray] = None
    Hr: Optional[np.ndarray] = None
    canvas: Optional[tuple] = None
    disp_i16: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None
    ev: Optional[dict] = None
    gt_idx: Optional[list] = None


def _shard_blocks(mesh, batch: int, device) -> list:
    """[(rows, device)] of a batch of ``batch`` pairs: the whole batch on
    ``device`` without a mesh, else ``mesh.data_blocks``."""
    if mesh is None:
        return [(slice(0, batch), _device(device))]
    if isinstance(mesh, ProcessGroupMesh):
        raise NotImplementedError(
            "run_batch over a multi-process mesh: the host Loop-Zhang stage reads "
            "every pair's F, which one process of the group does not hold (the JAX "
            "package has no such path either); use a one-process make_mesh")
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    return [(rows, _device(dev)) for rows, dev in mesh.data_blocks(batch)]


def _stage_upload(pairs, config: PipelineConfig, uniforms, blocks) -> List[_Staged]:
    """Pad the whole batch to one shape, stack each shard's pairs on the
    host and queue its uploads to its device."""
    B = len(pairs)
    hmax = max(p.height for p in pairs)
    wmax = max(p.width for p in pairs)
    hmax += (-hmax) % 8
    wmax += (-wmax) % 128
    if uniforms is None:
        uniforms = batch_uniforms(config, B)
    uniforms = torch.as_tensor(uniforms, dtype=torch.float32)
    want = (B, config.ransac.num_hypotheses, config.frontend.max_keypoints)
    if tuple(uniforms.shape) != want:
        raise ValueError(f"uniforms of shape {tuple(uniforms.shape)}, want {want}")
    timings: Dict[str, float] = {}
    shards = []
    with span("batch.upload"):
        for rows, device in blocks:
            padded = [pad_to(p, hmax, wmax) for p in pairs[rows]]

            def stack(field, dtype=None):
                return _to_device(np.stack([np.asarray(getattr(p, field), dtype)
                                            for p in padded]), device)

            shards.append(_Staged(
                pairs=pairs[rows], padded=padded, hmax=hmax, wmax=wmax, device=device,
                L=stack("image_left").to(torch.float32),
                R=stack("image_right").to(torch.float32),
                KL=stack("intrinsics_left", np.float32),
                KR=stack("intrinsics_right", np.float32),
                uniforms=_to_device(uniforms[rows].numpy(), device), timings=timings))
    return shards


def _stage_pose_dispatch(st: _Staged, config: PipelineConfig) -> None:
    t0 = time.perf_counter()
    st.pose = _pose_dispatch(st.L, st.R, st.KL, st.KR, st.uniforms, config)
    _add(st.timings, "pose_dispatch", time.perf_counter() - t0)


def _stage_settle(st: _Staged, config: PipelineConfig) -> None:
    """Wait for the pose outputs and settle BA (``pose_batch``'s second
    half): the host reads of F, ``valid`` and the error."""
    t0 = time.perf_counter()
    st.pose = settle_pose(st.pose, st.KL, st.KR, config)             # sync point
    st.F = st.pose.fundamental.cpu().numpy().astype(np.float64)
    valid = st.pose.valid.cpu().numpy()
    st.err_ba = st.pose.reproj_error_ba.cpu().numpy()
    st.pose_ok = valid & (st.err_ba < 50.0)
    _add(st.timings, "pose", time.perf_counter() - t0)


def _stage_homographies(st: _Staged, config: PipelineConfig) -> None:
    """Host Loop-Zhang for each pair whose pose is sound, and the canvas."""
    B = len(st.pairs)
    t0 = time.perf_counter()
    with span("rectify.homographies"):
        pose_ok = st.pose_ok
        Hl = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        Hr = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
        for i in range(B):
            if not pose_ok[i]:
                continue
            shape = (st.pairs[i].height, st.pairs[i].width)
            try:
                # the pair's TRUE shape, not the batch padding: the shearing stage
                # normalises by the image corners, and the back-warp resamples
                # disparity values, so another canvas scale rescales them
                homs = loop_zhang_homographies(st.F[i], shape, shape)
            except np.linalg.LinAlgError:      # a degenerate F fails its pair alone
                pose_ok[i] = False
                continue
            Hl[i] = homs.H_left.astype(np.float32)
            Hr[i] = homs.H_right.astype(np.float32)
        st.Hl, st.Hr = Hl, Hr
        st.canvas = static_canvas((st.hmax, st.wmax), (st.hmax, st.wmax), config.rectify)
    _add(st.timings, "loop_zhang_host", time.perf_counter() - t0)


def _stage_dense_dispatch(st: _Staged, config: PipelineConfig) -> None:
    """Queue the dense stage and the batched metric."""
    B = len(st.pairs)
    t0 = time.perf_counter()
    out_shape = (st.hmax, st.wmax)
    with span("rectify.warp"):
        # both sides' warps at once: one launch of the warp kernel on the card
        rect = warp_perspective([*st.L, *st.R], np.concatenate([st.Hl, st.Hr]), st.canvas)
    rect_l, rect_r = rect[:B], rect[B:]
    with span("disparity"):
        # the matcher's kernels take one pair: one K1 and one K1b launch each
        disp_rect = torch.stack([compute_disparity(rect_l[i], rect_r[i], config)
                                 for i in range(B)])
    # NN back-warp of disparity VALUES (the reference's approximation,
    # rectification.cpp:70-88, with the right image's homography)
    disp = warp_perspective(disp_rect, host_inverse(st.Hr), out_shape, method="nearest")
    recon = config.recon
    disp_clean = vmap(lambda d: remove_disparity_outliers(
        d, recon.outlier_kernel, recon.outlier_front, recon.outlier_back))(disp)
    st.depth = disparity_to_depth(disp_clean, st.KR[:, 0, 0, None, None], recon.baseline)
    # disparities are integers (argmin indices through an exact NN
    # back-warp) well inside int16; rint, so a subpixel matcher would round
    st.disp_i16 = torch.round(disp).to(torch.int16)

    # every pair with GT and a mask scored in one batched call
    st.gt_idx = [i for i, p in enumerate(st.padded)
                 if p.disp_right_gt is not None and p.mask_right_nocc is not None]
    if st.gt_idx:
        st.ev = _evaldisp_batch(
            disp[st.gt_idx],
            _to_device(np.stack([st.padded[i].disp_right_gt for i in st.gt_idx]),
                       st.device),
            _to_device(np.stack([st.padded[i].mask_right_nocc for i in st.gt_idx]),
                       st.device),
            _to_device(np.asarray([float(st.pairs[i].ndisp or 1e9) for i in st.gt_idx],
                                  np.float32), st.device))
    _add(st.timings, "dense_dispatch", time.perf_counter() - t0)


def _stage_host_geometry(st: _Staged, config: PipelineConfig) -> None:
    """Wait for the pose outputs, settle BA, run host Loop-Zhang, queue the
    dense stage and the batched metric."""
    _stage_settle(st, config)
    _stage_homographies(st, config)
    _stage_dense_dispatch(st, config)


def _stage_collect(st: _Staged, fetch_depth: bool) -> BatchResult:
    """Wait for one shard's downloads and assemble its result."""
    B = len(st.pairs)
    t0 = time.perf_counter()
    with span("entry.download"):
        disp_np = st.disp_i16.cpu().numpy().astype(np.float32)
        depth_np = st.depth.cpu().numpy() if fetch_depth else None
    _add(st.timings, "dense", time.perf_counter() - t0
         + st.timings.pop("dense_dispatch", 0.0))

    metrics: List[Dict[str, float]] = [
        {"pose_ok": float(st.pose_ok[i]), "reproj_error_ba": float(st.err_ba[i])}
        for i in range(B)]
    if st.gt_idx:
        ev = {k: v.cpu().numpy() for k, v in st.ev.items()}
        for j, i in enumerate(st.gt_idx):
            metrics[i].update({k: float(v[j]) for k, v in ev.items()})

    return BatchResult(disparity=disp_np, depth=depth_np, pose=st.pose,
                       pose_ok=st.pose_ok, metrics=metrics, timings=st.timings)


def _collect(shards: List[_Staged], fetch_depth: bool) -> BatchResult:
    """Every shard's result in data order, concatenated along B: the
    arrays on the host, each pose field on the first shard's device (as
    ``Mesh.assemble`` places a global output)."""
    parts = [_stage_collect(st, fetch_depth) for st in shards]
    if len(parts) == 1:
        return parts[0]
    first = shards[0].device
    return BatchResult(
        disparity=np.concatenate([r.disparity for r in parts]),
        depth=np.concatenate([r.depth for r in parts]) if fetch_depth else None,
        pose=PoseEstimate(*(torch.cat([f.to(first) for f in fields])
                            for fields in zip(*(r.pose for r in parts)))),
        pose_ok=np.concatenate([r.pose_ok for r in parts]),
        metrics=[m for r in parts for m in r.metrics],
        timings=parts[0].timings)


def run_batch(
    pairs: Sequence[StereoPair],
    config: PipelineConfig = PipelineConfig(),
    uniforms: Optional[torch.Tensor] = None,
    mesh=None,
    fetch_depth: bool = True,
    device="cuda",
) -> BatchResult:
    """Reconstruction of a batch of stereo pairs on ``device`` (reference
    main.cpp flow, batched; see the module docstring).

    ``uniforms``: the RANSAC draws, (B, num_hypotheses, max_keypoints);
    by default ``batch_uniforms(config, B)``. ``fetch_depth=False`` skips
    the depth download (``BatchResult.depth`` is None).

    ``mesh``: a one-process ``parallel.mesh.Mesh`` (``make_mesh``) splits
    the batch over its ``data`` axis, data shard i on the device of mesh
    shard (i, 0); ``device`` is then not consulted. B must be a multiple of
    ``data`` (``ValueError``); a ``multihost.ProcessGroupMesh`` raises
    ``NotImplementedError``. The result is the whole batch's, in order;
    its timings span all shards."""
    with span("run_batch"):
        shards = _stage_upload(pairs, config, uniforms,
                               _shard_blocks(mesh, len(pairs), device))
        with span("pose"):
            for st in shards:
                _stage_pose_dispatch(st, config)
            _stage_settle(shards[0], config)
        for i, st in enumerate(shards):
            if i:
                with span("pose"):
                    _stage_settle(st, config)
            _stage_homographies(st, config)
            with span("dense"):
                _stage_dense_dispatch(st, config)
                if i == len(shards) - 1:
                    # the last shard's span runs on through every shard's downloads
                    res = _collect(shards, fetch_depth)
    res.timings["pose"] += res.timings.pop("pose_dispatch", 0.0)
    return res


def run_batches(
    batches: Sequence[Sequence[StereoPair]],
    config: PipelineConfig = PipelineConfig(),
    mesh=None,
    fetch_depth: bool = True,
    device="cuda",
) -> List[BatchResult]:
    """Several batches, software-pipelined: batch i+1's upload and pose
    (every shard's) are queued before batch i's host geometry waits for
    its pose, and batch i's downloads wait while i+1 computes. Batch i's
    results equal ``run_batch(batches[i], config, batch_uniforms(config,
    len(batches[i]), i), mesh=mesh)``; its timings keep ``pose_dispatch``
    apart from ``pose``."""
    if not batches:
        return []
    blocks = [_shard_blocks(mesh, len(b), device) for b in batches]
    n = len(batches)
    sts: List[Optional[List[_Staged]]] = [None] * n
    results: List[Optional[BatchResult]] = [None] * n
    for i in range(n):
        sts[i] = _stage_upload(batches[i], config,
                               batch_uniforms(config, len(batches[i]), i), blocks[i])
        for st in sts[i]:
            _stage_pose_dispatch(st, config)
        if i >= 1:
            for st in sts[i - 1]:
                _stage_host_geometry(st, config)
        if i >= 2:
            results[i - 2] = _collect(sts[i - 2], fetch_depth)
            sts[i - 2] = None
    for st in sts[n - 1]:
        _stage_host_geometry(st, config)
    if n >= 2:
        results[n - 2] = _collect(sts[n - 2], fetch_depth)
    results[n - 1] = _collect(sts[n - 1], fetch_depth)
    return results
