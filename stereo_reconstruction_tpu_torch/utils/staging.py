"""Staged artefacts and resume.

Host copy of ``stereo_reconstruction_tpu/utils/staging.py``. The reference
pipeline is file-staged (the disparity map is written to a PNG and read
back, main.cpp:42,50); here every stage writes a typed artefact (float PFM
for arrays, JSON for poses and metrics) under ``<root>/<scenario>/``, and
a run can resume from the stages that exist.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import numpy as np

from stereo_reconstruction_tpu_torch.io.pfm import read_pfm, write_pfm


@dataclasses.dataclass
class StageStore:
    """Artefact directory for one scenario."""

    root: str
    scenario: str

    def _path(self, stage: str, ext: str) -> str:
        return os.path.join(self.root, self.scenario, f"{stage}.{ext}")

    def has(self, stage: str, kind: str = "pfm") -> bool:
        return os.path.exists(self._path(stage, kind))

    def save_array(self, stage: str, array: np.ndarray) -> str:
        path = self._path(stage, "pfm")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_pfm(path, np.asarray(array, np.float32))
        return path

    def load_array(self, stage: str) -> np.ndarray:
        return read_pfm(self._path(stage, "pfm"))

    def save_json(self, stage: str, payload: Dict[str, Any]) -> str:
        path = self._path(stage, "json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=_np_default)
        return path

    def load_json(self, stage: str) -> Dict[str, Any]:
        with open(self._path(stage, "json")) as f:
            return json.load(f)

    def resume_or_compute(self, stage: str, compute, kind: str = "pfm"):
        """The staged artefact if present, else ``compute()``, staged."""
        if kind == "pfm" and self.has(stage, "pfm"):
            return self.load_array(stage)
        if kind == "json" and self.has(stage, "json"):
            return self.load_json(stage)
        value = compute()
        if kind == "pfm":
            self.save_array(stage, value)
        else:
            self.save_json(stage, value)
        return value


def _np_default(obj):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)
