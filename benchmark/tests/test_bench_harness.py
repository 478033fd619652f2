"""The harness on the CPU: what it imports, how it finds a cell's files
by name, the window's arithmetic, the trace's idle share, and the
command's refusal without a card."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from benchmark import harness, kineto

ROOT = harness.ROOT


def test_nothing_imported_is_jax():
    """Every module of every cell, the control script and the program's
    entry points, loaded in a fresh process: no top-level name is jax,
    jaxlib, flax or the JAX package (compared whole: the port's own name
    begins with the JAX package's)."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark import harness, kineto, roofline, scenes, control\n"
        "spec = harness.load_spec()\n"
        "cells = [harness.cell(spec, w['name']) for w in spec['workloads']]\n"
        "for c in cells:\n"
        "    for m in c.end_to_end + c.per_layer:\n"
        "        harness.metric_reader(m['name'])\n"
        "import stereo_reconstruction_tpu_torch.pipeline\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "stereo_reconstruction_tpu_torch" in loaded
    assert harness.forbidden_modules(loaded) == []


def test_forbidden_names_compared_whole():
    names = ["stereo_reconstruction_tpu_torch.ops", "jaxtyping", "flaxen", "numpy"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["jax.numpy", "stereo_reconstruction_tpu.ops"]) == [
        "jax.numpy", "stereo_reconstruction_tpu.ops"]


def test_cells_found_by_name_and_extended_by_files_alone(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric are
    added to a copy by new files and BENCHMARK.json entries; no file of
    the benchmark changes, and the harness finds them all."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    spec = harness.load_spec()
    (tmp_path / "benchmark/configs/throwaway_cfg.json").write_text(json.dumps(
        {"image": {"height": 8, "width": 8}, "pipeline": {}}))
    (tmp_path / "benchmark/configs/throwaway_cfg.py").write_text("MARK = 'reference'\n")
    (tmp_path / "benchmark/traffic/throwaway_mix.json").write_text(json.dumps(
        {"entry": "run_pair", "pose": "fixed", "pool": 1, "limits": {}}))
    (tmp_path / "benchmark/metrics/throwaway_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    spec["configs"].append({"name": "throwaway_cfg", "source": "https://example.org/x",
                            "file": "benchmark/configs/throwaway_cfg.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "throwaway_cell", "config": "throwaway_cfg",
                              "traffic": "throwaway_mix", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "throwaway_metric.sub", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "entry",
                              "moves": "pairs_per_s", "workloads": ["throwaway_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    c = harness.cell(harness.load_spec(tmp_path), "throwaway_cell", tmp_path)
    assert c.config["image"] == {"height": 8, "width": 8}
    assert c.reference.MARK == "reference"
    assert c.traffic["entry"] == "run_pair" and hasattr(c.entry, "Entry")
    assert [m["name"] for m in c.end_to_end] == ["setup_s"]
    assert [m["name"] for m in c.per_layer] == ["throwaway_metric.sub"]
    assert harness.metric_reader("throwaway_metric.sub", tmp_path)(None) == 42.0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_every_listed_metric_has_a_reader():
    spec = harness.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_window_rate_and_tail_over_all_requests():
    """The window runs while less than ``seconds`` have passed and closes
    at the last result; the rate is every request over all of that time,
    and the tail is over every request."""
    now = [100.0]
    durations = iter([0.4, 0.1, 0.1, 0.1, 0.5, 0.2, 9.0])

    def request(i):
        now[0] += next(durations)
        return {"stage": 0.01 * i}

    w = harness.run_window(request, 1.2, clock=lambda: now[0])
    assert w.requests == 6
    assert w.seconds == pytest.approx(1.4)
    assert w.latencies == pytest.approx([0.4, 0.1, 0.1, 0.1, 0.5, 0.2])
    assert [s["stage"] for s in w.spans] == pytest.approx([0.0, 0.01, 0.02, 0.03, 0.04, 0.05])
    ctx = harness.Context(None, w, 2, setup_s=3.5)
    assert harness.metric_reader("pairs_per_s")(ctx) == pytest.approx(12 / 1.4)
    assert harness.metric_reader("latency_p95_ms")(ctx) == pytest.approx(
        1e3 * np.percentile([0.4, 0.1, 0.1, 0.1, 0.5, 0.2], 95))
    assert harness.metric_reader("setup_s")(ctx) == 3.5


def test_reservoir_is_uniform_and_seeded():
    picks = []
    for seed in range(400):
        r = harness.Reservoir(2, seed)
        for i in range(10):
            r.offer(i)
        picks += r.items
        again = harness.Reservoir(2, seed)
        for i in range(10):
            again.offer(i)
        assert again.items == r.items
    counts = np.bincount(picks, minlength=10)
    assert counts.min() > 40 and counts.max() < 120


def _ev(name, a, b, device=True):
    return kineto.Event(name, a, b, device)


def test_idle_share_from_events():
    evs = [_ev("k1", 0, 10), _ev("k2", 5, 20), _ev("k3", 30, 40), _ev("copy", 60, 70),
           _ev("aten::mm", 18, 35, False), _ev("cudaLaunchKernel", 21, 29, False),
           _ev("aten::add", 41, 59, False), _ev("aten::sum", 45, 50, False)]
    assert kineto.busy_ns(evs) == 40
    assert kineto.idle_pct(evs, 100) == pytest.approx(60.0)
    assert kineto.device_seconds(evs, lambda n: n.startswith("k")) == pytest.approx(35e-9)
    b = kineto.breakdown(evs, 0, 80)
    assert b["device_ops"][0] == ["k2", pytest.approx(15e-9)]
    # gaps: [20, 30) under the launch inside aten::mm, [40, 60) at its
    # middle under aten::sum, [70, 80) under nothing
    assert dict((k, v) for k, v in b["idle_gaps"]) == {
        "cudaLaunchKernel": pytest.approx(10e-9), "aten::sum": pytest.approx(20e-9),
        "python": pytest.approx(10e-9)}


def test_kineto_reader_on_a_cpu_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    evs = kineto.events(prof)
    assert any(e.name == "aten::mm" and not e.device and e.end_ns >= e.start_ns for e in evs)
    assert kineto.busy_ns(evs) == 0


@pytest.mark.parametrize("bare", [False, True])
def test_command_fails_without_a_card(tmp_path, bare):
    """No CUDA device (and, ``bare``, a directory holding only
    BENCHMARK.json and the benchmark): a non-zero exit and no result."""
    cwd = ROOT
    if bare:
        shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        cwd = tmp_path
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ssd_pair_fixedF",
                          "--seed", str(2**33 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=cwd, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
