"""Spans, stage timing and structured metrics (JSONL).

Port of ``stereo_reconstruction_tpu/utils/profiling.py`` (a stage timer
whose fences wait for the device, ``torch.cuda.synchronize`` where JAX
calls ``block_until_ready``, and a JSONL appender), plus the port's one
span recorder.

``span(name)`` marks a region of the program. While a ``torch.profiler``
session is active (``torch.autograd._profiler_enabled()``, read when the
outermost span of a request opens, so a request is recorded whole or not
at all), every span of that request is kept in a bounded buffer in
memory: its name, the request (shared by every span under one outermost
span), the enclosing span, and its start and end on the clock the
profiler stamps its events with (Unix-epoch ns: ``perf_counter_ns`` plus
one anchor a request, ``time_ns() - perf_counter_ns()``, so a clock step
never lands inside a request). A recorded span is also a
``torch.profiler.record_function`` range of the same name, and a span
given a CUDA ``device`` brackets its work with a pair of CUDA events.
Nothing is written out: ``spans()`` reads the buffer, ``clear()``
empties it, ``dropped()`` counts the spans a full buffer refused. With
no profiler session a span is one flag read and a shared null context,
so a session that starts inside a request records that request's later
spans as requests of their own.

The recorder serves one thread, the one that runs the requests.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch

CAPACITY = 1 << 16          # spans the buffer holds before it drops


class SpanRecord(NamedTuple):
    name: str
    request: int            # shared by every span under one outermost span
    parent: int             # index in ``spans()`` of the enclosing span; -1 outermost
    start_ns: int           # Unix-epoch ns, the profiler's clock
    end_ns: int
    device_ms: Optional[float]   # CUDA-event time of a device span, else None


class _Recorder:
    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        # [name, request, parent, start_ns, end_ns, (start, end) CUDA events or None]
        self.records: List[list] = []
        self.open: List[int] = []   # indices of the recorded request's open spans; -1 dropped
        self.request = -1
        self.anchor = 0
        self.dropped = 0


_RECORDER = _Recorder()
_NULL = contextlib.nullcontext()
# ``torch.profiler.record_function``'s range from C++: a tenth of its cost
_RecordFunction = torch._C._profiler._RecordFunctionFast


class _Span:
    __slots__ = ("name", "device", "index", "range")

    def __init__(self, name: str, device: Optional[torch.device]):
        self.name, self.device = name, device

    def __enter__(self):
        rec = _RECORDER
        if not rec.open:
            rec.request += 1
            rec.anchor = time.time_ns() - time.perf_counter_ns()
        parent = rec.open[-1] if rec.open else -1
        self.range = _RecordFunction(self.name)
        self.range.__enter__()
        if len(rec.records) >= rec.capacity:
            rec.dropped += 1
            self.index = -1
        else:
            events = None
            if self.device is not None and self.device.type == "cuda":
                stream = torch.cuda.current_stream(self.device)
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record(stream)
            self.index = len(rec.records)
            rec.records.append([self.name, rec.request, parent,
                                time.perf_counter_ns() + rec.anchor, 0, events])
        rec.open.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = _RECORDER
        rec.open.pop()
        if self.index >= 0:
            record = rec.records[self.index]
            record[4] = time.perf_counter_ns() + rec.anchor
            if record[5] is not None:
                record[5][1].record(torch.cuda.current_stream(self.device))
        self.range.__exit__(*exc)
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A context manager marking one region of the program, recorded
    while a profiler session is active (see the module's docstring);
    ``device``, a CUDA device whose current stream runs the region's
    work, adds the region's device time (``SpanRecord.device_ms``)."""
    if _RECORDER.open or torch.autograd._profiler_enabled():
        return _Span(name, device)
    return _NULL


def spans() -> List[SpanRecord]:
    """The recorded spans, in the order they opened. A device span's
    time is read from its events without a wait: read after the device
    has finished the spans' work (a synchronise), between requests."""
    return [SpanRecord(name, request, parent, start, end,
                       events[0].elapsed_time(events[1]) if events else None)
            for name, request, parent, start, end, events in _RECORDER.records]


def dropped() -> int:
    """Spans refused since the last ``clear()`` because the buffer was
    full; a reader of ``spans()`` trusts nothing while it is non-zero."""
    return _RECORDER.dropped


def clear() -> None:
    """Empty the buffer and zero ``dropped()`` (between requests)."""
    _RECORDER.records.clear()
    _RECORDER.dropped = 0


def synchronize(value) -> None:
    """Wait for every CUDA device that holds a tensor of ``value`` or is
    named in it (a tensor or torch.device, or a tuple, list, NamedTuple or
    dict of them)."""
    devices = set()

    def visit(v):
        if isinstance(v, torch.Tensor):
            v = v.device
        if isinstance(v, torch.device):
            if v.type == "cuda":
                devices.add(v)
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
        """Times a stage, a ``span``: host clock around its work and a
        wait, at its end, for ``outputs`` (tensors or devices)."""
        t0 = time.perf_counter_ns()
        with span(name):
            yield
            synchronize(outputs)
        self.timings[name] = self.timings.get(name, 0.0) + (time.perf_counter_ns() - t0) / 1e9

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
