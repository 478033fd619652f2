"""Where K4's time goes a diagonal, in cycles, from clocks.patch.

clocks.patch (wrong output by design) reads clock64 around each part of
the scan's diagonal loop in warp 0 of CTA 0 and writes the cycles a
diagonal into the first seven outputs. On a machine with the card, after
``perf/k4_variants/time.sh prepare``:

    cd build/k4_variants/clocks && python3 ../../../perf/k4_variants/clocks.py

prints them for K4 at 375x450, chunk 20, D=100 and 200, for one column,
one 20-column strip and the whole width.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
from chip_smoke import perceptual_volume  # noqa: E402
from stereo_reconstruction_tpu_torch.perceptual import scan  # noqa: E402

dev = torch.device("cuda", 0)
parts = ("wait", "prelude", "candidates", "redux", "store + arrive", "copies")
for D in (100, 200):
    vol = torch.from_numpy(perceptual_volume(np.random.default_rng(0), 375, D, 450)).to(dev)
    table = scan.weight_table(D, 25.0, 0.85, dev)
    for w in (1, 20, 450):
        r = scan.window_scan(vol[:, :, :w].contiguous(), table, 20).flatten()[:7].tolist()
        print(f"D={D} W={w}, cycles a diagonal of warp 0: "
              + ", ".join(f"{k} {v:.0f}" for k, v in zip(parts, r)) + f"; the loop {r[6]:.0f}")
