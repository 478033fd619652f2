"""The benchmark of the PyTorch + CUDA port, driven by ``BENCHMARK.json``.

One run measures one cell once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in files of its own, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the configuration as it is run, and beside it
  ``configs/<config>.py``, its plain reference;
* ``traffic/<traffic>.json``: the mix's parameters; its ``entry`` names the
  request kind, ``entries/<entry>.py`` (a class ``Entry`` that sets up the
  inputs, makes one request of the program, and checks what the window
  produced against the reference);
* ``metrics/<metric>.py``: a ``read(ctx)`` for one metric (end-to-end
  ones read the window's host clock, per-layer ones the program's spans,
  the trace or the shapes); a dotted name such as
  ``device_idle_pct.fixedF`` falls back to ``metrics/device_idle_pct.py``.

A run: set-up (imports, the inputs from the seed, one warm-up request at
the cell's shapes), then a closed loop of one client for ``--seconds``:
each request waits for its result. The window closes when the first
request to end after ``--seconds`` ends, so its rate counts all of its
work and all of its time. With ``--trace 1`` a few more requests follow
under ``torch.profiler`` (device activity and the CUDA runtime calls) and
the cell's per-layer metrics are read; with ``--trace 0`` its end-to-end
metrics. Then the memory peak is read, the
program's outputs are checked against the reference, the process is
searched for JAX, and the last line of standard output is the result.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
BENCH = "benchmark"
PROGRAM = "stereo_reconstruction_tpu_torch"
# top-level module names that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_reconstruction_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def by_name(items, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path, kind: str):
    """The module of a file found by name (dotted names are fine)."""
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {path} is missing")
    mod_name = f"benchmark_{kind}_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``metrics/<name>.py``, else of the file named by the
    part of ``name`` before its first dot."""
    path = root / BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        path = root / BENCH / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, "metric").read


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict              # configs/<config>.json
    traffic: dict             # traffic/<traffic>.json
    entry: object             # entries/<entry>.py
    reference: object         # configs/<config>.py
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path


def _reported(metric: dict, workload: str, end_to_end_names=None) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return end_to_end_names is None or metric["moves"] in end_to_end_names


def cell(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    """Everything one cell needs, found by the names in ``spec``."""
    w = by_name(spec["workloads"], workload, "workload")
    cfg_entry = by_name(spec["configs"], w["config"], "configuration")
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(root / BENCH / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in spec["end_to_end"] if _reported(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reported(m, workload, names)]
    return Cell(w, config, traffic,
                load_module(root / BENCH / "entries" / f"{traffic['entry']}.py", "entry"),
                load_module((root / cfg_entry["file"]).with_suffix(".py"), "reference"),
                e2e, per_layer, root)


def forbidden_modules(names) -> List[str]:
    """The loaded modules whose top-level name is a forbidden one."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def finite(x: float) -> float:
    """x, or the largest float where x is not finite (a NaN reading must
    fail every limit)."""
    return x if math.isfinite(x) else sys.float_info.max


class Reservoir:
    """A uniform sample of at most ``k`` items of a stream, drawn from a
    seed (Algorithm R): which requests the check compares."""

    def __init__(self, k: int, seed: int):
        self.k, self.items, self.seen = k, [], 0
        self.rng = np.random.default_rng(seed)

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


@dataclasses.dataclass
class Window:
    requests: int
    seconds: float            # from the first call to the last result
    latencies: List[float]    # seconds, every request
    spans: List[Dict[str, float]]


def run_window(request: Callable[[int], Dict[str, float]], seconds: float,
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """A closed loop of one client: request i starts when request i - 1
    has returned, while less than ``seconds`` have passed."""
    latencies, spans = [], []
    t0 = t = clock()
    while t - t0 < seconds:
        spans.append(request(len(latencies)))
        t_end = clock()
        latencies.append(t_end - t)
        t = t_end
    return Window(len(latencies), t - t0, latencies, spans)


def p95(values) -> float:
    """The 95th percentile of all values (linear between order
    statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads."""
    cell: Cell
    window: Window
    pairs_per_request: int
    setup_s: float
    trace: Optional[list] = None          # kineto.Event list of the traced requests
    traced_requests: int = 0
    traced_seconds: float = 0.0


def _parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell of the port once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(msg: str, code: int) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def measure(c: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            control: bool = False) -> dict:
    """One run of the cell on ``device`` after the device check: the
    result's keys, ``checks`` last ({name: {"value", "limit"}}).
    ``control`` puts the reference at the precision below the
    configuration's in the program's place."""
    import torch

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    chips = int(c.workload["chips"])
    entry = c.entry.Entry(c, seed, device, control=control)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    entry.warm_up()
    sync()
    setup_s = time.perf_counter() - t_start

    window = run_window(entry.request, seconds)
    lat = sorted(1e3 * x for x in window.latencies)
    print(f"window {window.requests} requests in {window.seconds!r} s, latency ms min "
          f"{lat[0]!r} median {lat[len(lat) // 2]!r} max {lat[-1]!r}", file=sys.stderr)
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": chips}
    ctx = Context(c, window, entry.pairs_per_request, setup_s)
    breakdown = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from benchmark import kineto

        n_traced = int(c.traffic["trace_requests"])
        # device activity only: recording every host op would slow the
        # host several times over and inflate the idle share
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sync()
            t0 = time.perf_counter()
            for i in range(n_traced):
                entry.request(window.requests + i, keep=False)
            sync()
            traced_s = time.perf_counter() - t0
        evs = kineto.events(prof)
        del prof
        ctx.trace, ctx.traced_requests, ctx.traced_seconds = evs, n_traced, traced_s
        busy = kineto.busy_ns(evs) / 1e9
        if busy <= 0:
            raise RuntimeError("the profiler saw no device work")
        device_info.update(busy_s=busy, window_s=traced_s)
        breakdown = kineto.breakdown(evs, min(e.start_ns for e in evs),
                                     max(e.end_ns for e in evs))
    device_info["memory_peak_bytes"] = (max(torch.cuda.max_memory_allocated(d)
                                            for d in range(chips)) if cuda else 0)

    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        value = metric_reader(m["name"], c.root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    checks, failed = entry.check()
    checks["failed_requests"] = (failed, 0)
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": window.requests, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv, t_start: float, root: Path = ROOT) -> int:
    args = _parse(argv)
    c = cell(load_spec(root), args.workload, root)
    import torch

    chips = int(c.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return _fail(f"{args.workload} needs {chips} CUDA device(s), this machine has {n}", 2)
    import stereo_reconstruction_tpu_torch as program

    if Path(program.__file__).resolve().parent.parent != root.resolve():
        return _fail(f"{PROGRAM} was imported from {program.__file__}, not from {root}", 2)
    result = measure(c, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                     t_start)
    found = forbidden_modules(list(sys.modules))
    if found:
        return _fail("the run loaded " + ", ".join(found), 3)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
