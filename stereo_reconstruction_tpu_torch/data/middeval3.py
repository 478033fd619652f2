"""MiddEval3 dataset index and loaders.

Host copy of ``stereo_reconstruction_tpu/data/middeval3.py`` (the
reference ``DataLoader``, ``src/DataLoader/data_loader.cpp:5-108``): the
``trainingH``/``testH`` scenario directories sorted by name, im0/im1,
``calib.txt``, and the GT disparity PFMs and nocc masks where present.

As in the JAX package, and unlike the reference: paths are explicit;
a missing GT file gives a ``None`` field; the scenario count is
discovered; images are RGB.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

from stereo_reconstruction_tpu_torch.data.records import StereoPair, pad_to
from stereo_reconstruction_tpu_torch.io.calib import parse_calib
from stereo_reconstruction_tpu_torch.io.image import read_image
from stereo_reconstruction_tpu_torch.io.pfm import read_pfm

# the scenarios used for the reference's final evaluations (main.cpp:19)
EVAL_SCENARIOS = (0, 5, 8, 12, 13)  # Adirondack, MotorcycleE, Piano, Shelves, Teddy


class MiddEval3:
    def __init__(self, root: str):
        """``root`` is the MiddEval3 directory containing trainingH/testH."""
        self.root = root
        self.training_paths = self._scan("trainingH")
        self.test_paths = self._scan("testH")

    def _scan(self, split: str) -> List[str]:
        path = os.path.join(self.root, split)
        if not os.path.isdir(path):
            return []
        return sorted(os.path.join(path, d) for d in os.listdir(path)
                      if os.path.isdir(os.path.join(path, d)))

    @property
    def num_training(self) -> int:
        return len(self.training_paths)

    @property
    def num_test(self) -> int:
        return len(self.test_paths)

    def training_names(self) -> List[str]:
        return [os.path.basename(p) for p in self.training_paths]

    def load_training(self, index: int) -> StereoPair:
        """A training scenario with GT disparities and masks where present
        (reference loadTrainingScenario, data_loader.cpp:64-90)."""
        return self._load(self.training_paths[index], with_gt=True)

    def load_test(self, index: int) -> StereoPair:
        """A test scenario: images and intrinsics only (reference
        loadTestScenario, data_loader.cpp:92-108)."""
        return self._load(self.test_paths[index], with_gt=False)

    def _load(self, path: str, with_gt: bool) -> StereoPair:
        calib = parse_calib(os.path.join(path, "calib.txt"))
        pair = StereoPair(
            image_left=read_image(os.path.join(path, "im0.png")),
            image_right=read_image(os.path.join(path, "im1.png")),
            intrinsics_left=calib.cam0,
            intrinsics_right=calib.cam1,
            name=os.path.basename(path),
            ndisp=calib.ndisp,
        )
        if with_gt:
            pair = _attach_gt(pair, path)
        return pair

    def load_batch(self, indices: Sequence[int], height: Optional[int] = None,
                   width: Optional[int] = None, split: str = "training") -> List[StereoPair]:
        """Several scenarios zero-padded to one shape (``pad_to``)."""
        load = self.load_training if split == "training" else self.load_test
        pairs = [load(i) for i in indices]
        h = height or max(p.height for p in pairs)
        w = width or max(p.width for p in pairs)
        return [pad_to(p, h, w) for p in pairs]


def _attach_gt(pair: StereoPair, path: str) -> StereoPair:
    def _maybe_pfm(name):
        p = os.path.join(path, name)
        if os.path.exists(p):
            try:
                return read_pfm(p)
            except (ValueError, OSError):
                return None
        return None

    def _maybe_mask(name):
        p = os.path.join(path, name)
        return read_image(p, grayscale=True) if os.path.exists(p) else None

    return dataclasses.replace(
        pair,
        disp_left_gt=_maybe_pfm("disp0GT.pfm"),
        disp_right_gt=_maybe_pfm("disp1GT.pfm"),
        mask_left_nocc=_maybe_mask("mask0nocc.png"),
        mask_right_nocc=_maybe_mask("mask1nocc.png"),
    )


def downsample_pair(pair: StereoPair, factor: int = 2) -> StereoPair:
    """Area-downsample a pair (trainingH -> a trainingQ-like quarter size):
    images by block means, disparities strided and divided by ``factor``,
    masks strided, K's first two rows divided by ``factor``."""

    def _crop(a):
        a = np.asarray(a)
        return a[:(a.shape[0] // factor) * factor, :(a.shape[1] // factor) * factor]

    def _img(a):
        if a is None:
            return None
        a = _crop(np.asarray(a, dtype=np.float32))
        h, w = a.shape[0], a.shape[1]
        a = a.reshape(h // factor, factor, w // factor, factor, -1).mean(axis=(1, 3))
        return np.squeeze(a).astype(np.float32)

    def _disp(a):
        return None if a is None else _crop(a)[::factor, ::factor] / factor

    def _mask(a):
        return None if a is None else _crop(a)[::factor, ::factor]

    def _K(K):
        K = np.asarray(K, dtype=np.float32).copy()
        K[:2] /= factor
        return K

    return dataclasses.replace(
        pair,
        image_left=_img(pair.image_left),
        image_right=_img(pair.image_right),
        intrinsics_left=_K(pair.intrinsics_left),
        intrinsics_right=_K(pair.intrinsics_right),
        disp_left_gt=_disp(pair.disp_left_gt),
        disp_right_gt=_disp(pair.disp_right_gt),
        mask_left_nocc=_mask(pair.mask_left_nocc),
        mask_right_nocc=_mask(pair.mask_right_nocc),
        ndisp=max(1, pair.ndisp // factor),
    )
