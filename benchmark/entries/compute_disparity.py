"""Requests of ``pipeline.compute_disparity`` on rectified pairs.

Traffic parameters: ``pool`` (distinct ``scenes.rectified_pair`` pairs at
the configuration's size and disparity range, on the card, taken in
turn) and ``limits``. The VGG weights are the program's seeded He-init
ones, of a seed drawn from the run's seed; the reference draws the same
weights from that seed itself.

The check: every request's disparity against the reference's cost
volume (``configs/<config>.py``), made once per pair of the pool: at each
pixel, how far the chosen candidate's smoothed cost lies above the best
one, with the smoothing weights of the neighbours' choices in the same
disparity map (the gap a served token's logit keeps below the
reference's best, for an argmin), summed over the map; the worst request
of the window counts. Rounding flips only near-ties, by no more than the
rounding's own size, so the sum grows with the square of the error: the
float32 program and its TF32 control differ about 12x in it, against 2-3x
in the widest single gap or the number of flipped pixels.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import scenes
from benchmark.harness import finite


class Entry:
    pairs_per_request = 1

    def __init__(self, cell, seed: int, device, control: bool = False):
        from stereo_reconstruction_tpu_torch.config import from_jax_config
        from stereo_reconstruction_tpu_torch.pipeline import compute_disparity

        t, c = cell.traffic, cell.config
        h, w = c["image"]["height"], c["image"]["width"]
        self.limits = t["limits"]
        self.weights_seed = scenes.derive(seed, 4) % 2**32
        self.pipeline = c["pipeline"]
        self.config = from_jax_config(dict(self.pipeline, seed=self.weights_seed))
        D = self.config.matcher.max_disparity
        self.pairs = [tuple(torch.as_tensor(a, device=device) for a in scenes.rectified_pair(
            np.random.default_rng(scenes.derive(seed, 1, k)), h, w, D, device))
            for k in range(t["pool"])]
        self.device, self.control = torch.device(device), control
        self.reference = cell.reference
        self.compute_disparity = compute_disparity
        self.outputs = []         # (pool index, disparity) a request

    def _volume(self, k: int, low: bool = False):
        left, right = self.pairs[k]
        return self.reference.cost_volume(left, right, self.weights_seed,
                                          self.pipeline["perceptual"],
                                          self.config.matcher.max_disparity, low=low)

    def warm_up(self) -> None:
        self.request(-1, keep=False)

    def request(self, i: int, keep: bool = True):
        k = i % len(self.pairs)
        if self.control:
            cost = self._volume(k, low=True)
            disparity = self.reference.smooth(
                cost, self.reference.table_for(cost, self.pipeline["perceptual"]),
                self.pipeline["perceptual"]["chunk"]).cpu().numpy()
        else:
            disparity = self.compute_disparity(*self.pairs[k], self.config).cpu().numpy()
        if keep:
            self.outputs.append((k, disparity))
        return {}

    def check(self):
        """({name: (reading, limit)}, failed requests)."""
        torch.cuda.empty_cache() if self.device.type == "cuda" else None
        pcfg, excess = self.pipeline["perceptual"], [0.0]
        for k in sorted({k for k, _ in self.outputs}):
            cost = self._volume(k)
            table = self.reference.table_for(cost, pcfg)
            excess += [float(self.reference.forced_excess(cost, table, pcfg["chunk"], disp).sum())
                       for kk, disp in self.outputs if kk == k]
            del cost
        return {"cost_excess_sum": (finite(max(excess)), self.limits["cost_excess_sum"])}, 0
