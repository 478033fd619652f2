"""Cells of ``BENCHMARK.json`` cut to sizes a CPU test run holds."""

from __future__ import annotations

import copy
import dataclasses
import json
import time

import torch

from benchmark import harness

SIZES = {
    "ssd_pair_fixedF": dict(h=96, w=128, D=24, block=9),
    "ssd_pair_fixedF:posed_pool4": dict(h=240, w=320, D=48, block=9),
    "perceptual_rectified_pair": dict(h=10, w=16, D=6),
}


def small_cell(workload: str, traffic: str = "", root=harness.ROOT) -> harness.Cell:
    """The cell ``workload`` at ``SIZES[workload]``; ``traffic`` names
    another traffic file to run it under."""
    c = harness.cell(harness.load_spec(root), workload, root)
    c = dataclasses.replace(c, config=copy.deepcopy(c.config), traffic=copy.deepcopy(c.traffic))
    if traffic:
        with open(root / "benchmark" / "traffic" / f"{traffic}.json") as f:
            c.traffic = json.load(f)
        c.entry = harness.load_module(root / "benchmark" / "entries" / f"{c.traffic['entry']}.py",
                                      "entry")
    s = SIZES[workload + (f":{traffic}" if traffic else "")]
    c.config["image"] = {"height": s["h"], "width": s["w"]}
    p = c.config["pipeline"]
    p["matcher"]["max_disparity"] = s["D"]
    if "block" in s:
        p["matcher"]["block_size"] = s["block"]
    if "perceptual" in p:
        p["perceptual"]["max_disparity"] = s["D"]
    return c


def run(c: harness.Cell, seed: int, seconds: float = 1.0, control: bool = False,
        entry=None) -> dict:
    """``harness.measure`` on the CPU (the harness's look for a card
    skipped), with ``entry`` in place of the cell's Entry class if given."""
    if entry is not None:
        c = dataclasses.replace(c, entry=type("EntryModule", (), {"Entry": entry}))
    return harness.measure(c, seed, seconds, False, torch.device("cpu"), time.perf_counter(),
                           control=control)
