"""Middlebury ``calib.txt`` parser.

Host copy of ``stereo_reconstruction_tpu/io/calib.py`` (the reference's
string-surgery parser, ``src/DataLoader/data_loader.cpp:141-164``): the
``cam0=[fx 0 cx; 0 fy cy; 0 0 1]`` / ``cam1=[...]`` lines give the two 3x3
intrinsics, and the other ``key=value`` lines (doffs, baseline, width,
height, ndisp, vmin, vmax), which the reference drops, are kept as typed
fields.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np


@dataclasses.dataclass(frozen=True)
class Calibration:
    cam0: np.ndarray      # (3, 3) float32 left intrinsics
    cam1: np.ndarray      # (3, 3) float32 right intrinsics
    doffs: float = 0.0
    baseline: float = 0.0
    width: int = 0
    height: int = 0
    ndisp: int = 0
    vmin: int = 0
    vmax: int = 0


_CAM_RE = re.compile(r"cam([01])=\[([^\]]*)\]")


def parse_calib(path_or_text: str) -> Calibration:
    """Parse a calib.txt file path or its text content."""
    if "\n" in path_or_text or "=" in path_or_text.split("/")[-1]:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()

    cams = {}
    extras = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        m = _CAM_RE.match(line)
        if m:
            values = [float(v) for v in m.group(2).replace(";", " ").split()]
            if len(values) != 9:
                raise ValueError(f"expected 9 matrix entries, got {len(values)}")
            cams[int(m.group(1))] = np.array(values, dtype=np.float32).reshape(3, 3)
        elif "=" in line:
            key, value = line.split("=", 1)
            extras[key.strip()] = value.strip()

    if 0 not in cams or 1 not in cams:
        raise ValueError("calib.txt must define cam0 and cam1")

    def _f(key, default=0.0):
        return float(extras.get(key, default))

    def _i(key, default=0):
        return int(float(extras.get(key, default)))

    return Calibration(
        cam0=cams[0],
        cam1=cams[1],
        doffs=_f("doffs"),
        baseline=_f("baseline"),
        width=_i("width"),
        height=_i("height"),
        ndisp=_i("ndisp"),
        vmin=_i("vmin"),
        vmax=_i("vmax"),
    )
