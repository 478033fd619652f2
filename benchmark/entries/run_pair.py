"""Requests of ``pipeline.run_pair`` on calibrated pairs.

Traffic parameters: ``pool`` (distinct ``scenes.nonplanar_scene`` pairs
at the configuration's size, taken in turn), ``pose`` (``"estimate"``:
the pose stage runs, with fresh RANSAC draws a request from the seed and
the request's index; ``"fixed"``: ``fixed_F`` is the scene's true F),
``checked_requests`` (how many requests the check draws from the window)
and ``limits``.

The check: every request's pose (``"estimate"``) against the scene's
true R and T, and ``pose_ok``; a sample of the window's requests, drawn
from the seed, against the reference (``configs/<config>.py``), which
rectifies with the F the request used (the truth, or the pose stage's
output) and runs the chain to disparity and depth again.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import scenes
from benchmark.harness import Reservoir, finite


def mismatch_pct(got: np.ndarray, want: np.ndarray, rtol: float = 0.0) -> float:
    """The share, in %, of entries of ``got`` that differ from ``want``:
    by anything where ``rtol`` is 0, else by more than ``rtol`` of
    ``want``; equal infinities agree and a NaN never does. A shape that
    differs is 100%."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return 100.0
    same = got == want
    if rtol:
        with np.errstate(invalid="ignore"):
            same |= np.abs(got - want) <= rtol * np.abs(want)
    return 100.0 * float(np.mean(~same))


def pose_angles(pose, R, T):
    """(rotation, translation direction) angles in degrees between a 4x4
    pose and the true R and T."""
    pose = np.asarray(pose, np.float64)
    cos_r = (np.trace(pose[:3, :3] @ np.asarray(R, np.float64).T) - 1) / 2
    t = pose[:3, 3] / np.linalg.norm(pose[:3, 3])
    cos_t = t @ (np.asarray(T, np.float64) / np.linalg.norm(T))
    return tuple(float(a) for a in np.degrees(np.arccos(np.clip([cos_r, cos_t], -1, 1))))


class Entry:
    pairs_per_request = 1

    def __init__(self, cell, seed: int, device, control: bool = False):
        from stereo_reconstruction_tpu_torch.config import from_jax_config
        from stereo_reconstruction_tpu_torch.data.records import StereoPair
        from stereo_reconstruction_tpu_torch.pipeline import run_pair

        t, c = cell.traffic, cell.config
        h, w = c["image"]["height"], c["image"]["width"]
        self.pipeline, self.limits = c["pipeline"], t["limits"]
        self.tolerance = c.get("pose_tolerance_deg")
        self.config = from_jax_config(self.pipeline)
        self.posed = {"estimate": True, "fixed": False}[t["pose"]]
        self.scenes = [scenes.nonplanar_scene(np.random.default_rng(scenes.derive(seed, 1, k)),
                                              h, w, device) for k in range(t["pool"])]
        self.pairs = [StereoPair(left, right, K.astype(np.float32), K.astype(np.float32),
                                 name=f"scene{k}")
                      for k, (left, right, K, _, _, _) in enumerate(self.scenes)]
        self.seed, self.device, self.control = seed, torch.device(device), control
        self.reference = cell.reference
        self.run_pair = run_pair
        self.sample = Reservoir(int(t["checked_requests"]), scenes.derive(seed, 2))
        self.poses = []           # (rotation deg, translation deg, pose_ok) a request

    def uniforms(self, i: int) -> torch.Tensor:
        r = self.config.ransac
        g = torch.Generator(self.device).manual_seed(scenes.derive(self.seed, 3, i))
        return torch.rand((r.num_hypotheses, self.config.frontend.max_keypoints),
                          generator=g, device=self.device)

    def warm_up(self) -> None:
        self.request(-1, keep=False)

    def request(self, i: int, keep: bool = True):
        k = i % len(self.pairs)
        left, right, K, R, T, F = self.scenes[k]
        if self.control:
            disparity, depth = self.reference.pair(left, right, K, F, self.pipeline,
                                                   self.device, low=True)
            if keep:
                self.poses.append((0.0, 0.0, True))
                self.sample.offer((k, F, disparity, depth))
            return {}
        if self.posed:
            res = self.run_pair(self.pairs[k], self.config, device=self.device,
                                uniforms=self.uniforms(i))
        else:
            res = self.run_pair(self.pairs[k], self.config, device=self.device, fixed_F=F)
        if keep:
            F_used = F
            if self.posed:
                self.poses.append((*pose_angles(res.pose.pose.cpu().numpy(), R, T),
                                   res.metrics["pose_ok"] == 1.0))
                F_used = res.pose.fundamental.cpu().numpy().astype(np.float64)
            self.sample.offer((k, F_used, res.disparity, res.depth))
        return res.timings

    def check(self):
        """({name: (reading, limit)}, failed requests), the reference run
        once per distinct (scene, F) of the sample."""
        checks, failed = {}, 0
        if self.posed:
            lim_r, lim_t = self.tolerance["rotation"], self.tolerance["translation"]
            failed = sum(1 for r, tr, ok in self.poses if not (ok and r <= lim_r and tr <= lim_t))
            checks["rotation_err_deg"] = (finite(max(r for r, _, _ in self.poses)), lim_r)
            checks["translation_err_deg"] = (finite(max(t for _, t, _ in self.poses)), lim_t)
        torch.cuda.empty_cache() if self.device.type == "cuda" else None
        refs, disp_pct, depth_pct = {}, [0.0], [0.0]
        for k, F, disparity, depth in self.sample.items:
            key = (k, np.asarray(F, np.float64).tobytes())
            if key not in refs:
                left, right, K = self.scenes[k][:3]
                refs[key] = self.reference.pair(left, right, K, F, self.pipeline, self.device)
            ref_disp, ref_depth = refs[key]
            disp_pct.append(mismatch_pct(disparity, ref_disp))
            depth_pct.append(mismatch_pct(depth, ref_depth, rtol=1e-3))
        checks["disparity_mismatch_pct"] = (max(disp_pct), self.limits["disparity_mismatch_pct"])
        checks["depth_mismatch_pct"] = (max(depth_pct), self.limits["depth_mismatch_pct"])
        return checks, failed
