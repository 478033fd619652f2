"""Stage timing and structured metrics (JSONL).

Port of ``stereo_reconstruction_tpu/utils/profiling.py``: a stage timer
whose fences wait for the device (``torch.cuda.synchronize`` where JAX
calls ``block_until_ready``) and whose stages are ``torch.profiler``
ranges (``record_function``, where JAX uses ``TraceAnnotation``), a JSONL
appender, and ``maybe_profile``, a ``torch.profiler`` trace around a block
written as a Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch


def synchronize(value) -> None:
    """Wait for every CUDA device that holds a tensor of ``value`` (a
    tensor, or a tuple, list, NamedTuple or dict of them)."""
    devices = set()

    def visit(v):
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                devices.add(v.device)
        elif isinstance(v, dict):
            for x in v.values():
                visit(x)
        elif isinstance(v, (tuple, list)):
            for x in v:
                visit(x)

    visit(value)
    for device in devices:
        torch.cuda.synchronize(device)


class StageTimer:
    def __init__(self):
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, *outputs):
        """Times a stage (a ``torch.profiler`` range); ``outputs`` are
        waited for at its end."""
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            synchronize(outputs)
            t = time.perf_counter() - t0
        self.timings[name] = self.timings.get(name, 0.0) + t

    def fence(self, name: str, value, t0: float):
        """Wait for ``value`` on its device; record the time since ``t0``."""
        synchronize(value)
        self.timings[name] = time.perf_counter() - t0


def append_jsonl(path: str, record: Dict[str, Any]) -> None:
    record = dict(record, ts=time.time())
    with open(path, "a") as f:
        f.write(json.dumps(record, default=_json_default) + "\n")


def _json_default(obj):
    import numpy as np

    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    return str(obj)


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where a card
    is present) written to ``<trace_dir>/trace.json`` when a directory is
    given; nothing otherwise."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
