"""Precomputed-disparity results loader (HitNet / perceptual artefacts).

Host copy of ``stereo_reconstruction_tpu/data/hitnet.py`` (the reference
DataLoader's HitNet side, ``src/DataLoader/data_loader.cpp:19-29,46-62,
127-139,166-203``): a ``results/HitNet/{trainingH,testH}`` tree of
per-scene directories whose ``im0_reference.png`` disparity images are
read as float maps, and the grayscale-PNG-as-disparity reader of the
reference's RUN_ALL=0 path (``main.cpp:11,46-65``), which feeds
``pipeline.reconstruct_from_disparity``.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from stereo_reconstruction_tpu_torch.io.image import read_image


def read_grayscale_disparity(path: str) -> np.ndarray:
    """uint8 grayscale PNG -> float32 disparity map (reference
    readGrayscaleImageAsDisparityMap, data_loader.cpp:191-203)."""
    return read_image(path, grayscale=True).astype(np.float32)


def read_hitnet_disparity(scenario_dir: str) -> np.ndarray:
    """``<scenario>/im0_reference.png`` as a float disparity map: channel 0
    of the 3-channel read, as the reference (data_loader.cpp:166-178); the
    artefacts are grayscale, so every channel is equal."""
    img = read_image(os.path.join(scenario_dir, "im0_reference.png"))
    return img[..., 0].astype(np.float32)


class PrecomputedDisparities:
    """Index over a results tree of per-scene precomputed disparities
    (scene directories sorted by name, data_loader.cpp:18-28)."""

    def __init__(self, root: str):
        """``root`` is e.g. ``results/HitNet`` containing trainingH/testH."""
        self.root = root
        self.training_paths = self._scan("trainingH")
        self.test_paths = self._scan("testH")

    def _scan(self, split: str) -> List[str]:
        path = os.path.join(self.root, split)
        if not os.path.isdir(path):
            return []
        return sorted(os.path.join(path, d) for d in os.listdir(path)
                      if os.path.isdir(os.path.join(path, d)))

    def load_training(self, index: int) -> np.ndarray:
        """loadTrainingDisparityHitNet (data_loader.cpp:205-215)."""
        return read_hitnet_disparity(self.training_paths[index])

    def load_test(self, index: int) -> np.ndarray:
        """loadTestDisparityHitNet (data_loader.cpp:217-227)."""
        return read_hitnet_disparity(self.test_paths[index])

    def load_training_dataset(self) -> List[np.ndarray]:
        return [self.load_training(i) for i in range(len(self.training_paths))]

    def load_test_dataset(self) -> List[np.ndarray]:
        return [self.load_test(i) for i in range(len(self.test_paths))]


def rescale_to_gt_mean(disparity: np.ndarray, gt_disparity: np.ndarray) -> np.ndarray:
    """Scale a (learned) disparity map so its mean over non-infinite pixels
    equals the GT's (test_reconstruction.cpp:118-121); unchanged where
    either mean is not finite or the map's mean is not positive."""
    mean = average_disparity(disparity)
    mean_gt = average_disparity(gt_disparity)
    if mean <= 0 or not np.isfinite(mean) or not np.isfinite(mean_gt):
        return np.asarray(disparity, np.float32)
    return np.asarray(disparity, np.float32) * np.float32(mean_gt / mean)


def average_disparity(disp: np.ndarray) -> float:
    """Mean over non-infinite pixels, negatives included (reference
    computeAverageDisparity, utils.cpp:8-20); NaN where none."""
    d = np.asarray(disp, np.float32)
    valid = ~np.isinf(d)
    if not valid.any():
        return float("nan")
    return float(d[valid].mean())
