"""Requests of ``pipeline_batch.run_batch`` on batches of calibrated pairs.

Traffic parameters: ``batch`` (pairs a request, the configuration's
``batch``), ``pool`` (distinct ``scenes.nonplanar_scene`` pairs at the
configuration's size; pair j of every request is scene j mod ``pool``),
``pose`` (``"estimate"``: the pose stage runs, with fresh RANSAC draws a
request, a (batch, hypotheses, keypoints) float32 CPU tensor drawn inside
the request from a generator seeded by the seed and the request's index),
``checked_pairs`` (how many of the window's pairs the check draws) and
``limits``.

The check: every pair's pose against its scene's true R and T, and its
``pose_ok``; a request fails where any of its pairs is past the tolerance
or not ``pose_ok``. A sample of the window's pairs, drawn from the seed,
against the reference (``configs/<config>.py``) on the padded arrays
``run_batch`` returns, the reference rectifying each with the F the
program's pose gave it: disparity over the whole padded frame, depth over
the pair's own pixels. In the padding depth is the focal length over the
outlier clamp's blur of mostly zero disparities, a blur as small as 0 that
one rounding-level disparity flip 250 pixels away moves by more than 1e-3
of itself (a black-boundary pixel at 0 against 153 moved 499 padded
pixels' depth past 1e-3 relative; the pair's own pixels there read a blur
of 24 or more).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import scenes
from benchmark.entries.run_pair import mismatch_pct, pose_angles
from benchmark.harness import Reservoir, finite


class Entry:
    pairs_per_request = 8

    def __init__(self, cell, seed: int, device, control: bool = False):
        from stereo_reconstruction_tpu_torch.config import from_jax_config
        from stereo_reconstruction_tpu_torch.data.records import StereoPair
        from stereo_reconstruction_tpu_torch.pipeline_batch import run_batch

        t, c = cell.traffic, cell.config
        if t["pose"] != "estimate":
            raise ValueError(f"run_batch traffic takes pose 'estimate', not {t['pose']!r}")
        self.batch = int(t["batch"])
        if self.batch != int(c.get("batch", self.batch)):
            raise ValueError(f"traffic batch {self.batch} against the configuration's "
                             f"{c['batch']}")
        self.pairs_per_request = self.batch
        self.shape = (c["image"]["height"], c["image"]["width"])
        self.pipeline, self.limits = c["pipeline"], t["limits"]
        self.tolerance = c["pose_tolerance_deg"]
        self.config = from_jax_config(self.pipeline)
        self.scenes = [scenes.nonplanar_scene(np.random.default_rng(scenes.derive(seed, 1, k)),
                                              *self.shape, device) for k in range(t["pool"])]
        pairs = [StereoPair(left, right, K.astype(np.float32), K.astype(np.float32),
                            name=f"scene{k}")
                 for k, (left, right, K, _, _, _) in enumerate(self.scenes)]
        self.members = [j % len(pairs) for j in range(self.batch)]
        self.pairs = [pairs[k] for k in self.members]
        self.seed, self.device, self.control = seed, torch.device(device), control
        self.reference = cell.reference
        self.run_batch = run_batch
        self.sample = Reservoir(int(t["checked_pairs"]), scenes.derive(seed, 2))
        self.poses = []           # a request: [(rotation deg, translation deg, pose_ok)]

    def uniforms(self, i: int) -> torch.Tensor:
        r = self.config.ransac
        g = torch.Generator().manual_seed(scenes.derive(self.seed, 3, i))
        return torch.rand((self.batch, r.num_hypotheses, self.config.frontend.max_keypoints),
                          generator=g)

    def warm_up(self) -> None:
        self.request(-1, keep=False)

    def _reference(self, k: int, F, low: bool = False):
        left, right, K = self.scenes[k][:3]
        return self.reference.pair(left, right, K, F, self.pipeline, self.device, self.shape,
                                   low=low)

    def request(self, i: int, keep: bool = True):
        if self.control:
            for k in self.members:
                F = self.scenes[k][5]
                disparity, depth = self._reference(k, F, low=True)
                if keep:
                    self.sample.offer((k, F, disparity, depth))
            if keep:
                self.poses.append([(0.0, 0.0, True)] * self.batch)
            return {}
        res = self.run_batch(self.pairs, self.config, uniforms=self.uniforms(i),
                             device=self.device)
        if keep:
            poses, F_all = res.pose.pose.cpu().numpy(), res.pose.fundamental.cpu().numpy()
            found = []
            for j, k in enumerate(self.members):
                R, T = self.scenes[k][3:5]
                ok = bool(res.pose_ok[j])
                found.append((*pose_angles(poses[j], R, T), ok))
                F = F_all[j].astype(np.float64) if ok else None
                self.sample.offer((k, F, res.disparity[j], res.depth[j]))
            self.poses.append(found)
        return res.timings

    def check(self):
        """({name: (reading, limit)}, failed requests), the reference run
        once per distinct (scene, F) of the sample."""
        lim_r, lim_t = self.tolerance["rotation"], self.tolerance["translation"]
        failed = sum(1 for found in self.poses
                     if not all(ok and r <= lim_r and t <= lim_t for r, t, ok in found))
        pairs = [p for found in self.poses for p in found]
        checks = {"rotation_err_deg": (max(finite(r) for r, _, _ in pairs), lim_r),
                  "translation_err_deg": (max(finite(t) for _, t, _ in pairs), lim_t),
                  "pairs_not_pose_ok": (sum(1 for _, _, ok in pairs if not ok), 0)}
        torch.cuda.empty_cache() if self.device.type == "cuda" else None
        refs, disp_pct, depth_pct = {}, [0.0], [0.0]
        for k, F, disparity, depth in self.sample.items:
            key = (k, None if F is None else np.asarray(F, np.float64).tobytes())
            if key not in refs:
                refs[key] = self._reference(k, F)
            ref_disp, ref_depth = refs[key]
            disp_pct.append(mismatch_pct(disparity, ref_disp))
            h, w = self.shape
            depth_pct.append(mismatch_pct(depth[:h, :w], ref_depth[:h, :w], rtol=1e-3))
        checks["disparity_mismatch_pct"] = (max(disp_pct), self.limits["disparity_mismatch_pct"])
        checks["depth_mismatch_pct"] = (max(depth_pct), self.limits["depth_mismatch_pct"])
        return checks, failed
