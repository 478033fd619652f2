"""The program's own spans (``stereo_reconstruction_tpu_torch.utils.profiling``,
recorded while the traced requests ran under ``torch.profiler``), and the
device's idle time inside them.

Span times are on the trace's clock (Unix-epoch ns). A reader returns
None where the program has no span recorder, where its buffer dropped a
span, or where no traced request recorded the spans it reads.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Callable, Dict, List, Optional, Tuple

from benchmark import kineto

Request = List[Tuple[int, object]]    # (index, SpanRecord) in opening order


def recorded():
    """The program's span records, or None (no recorder, or spans
    dropped)."""
    from stereo_reconstruction_tpu_torch.utils import profiling

    spans, dropped = getattr(profiling, "spans", None), getattr(profiling, "dropped", None)
    if spans is None or dropped is None or dropped():
        return None
    return spans()


def in_window(records, trace) -> Dict[int, Request]:
    """By request id, the records of each request whose outermost span
    lies inside the trace's window (its first event to its last), each
    as (its index in ``records``, the record): ``parent`` is such an
    index."""
    if not records or not trace:
        return {}
    t0, t1 = min(e.start_ns for e in trace), max(e.end_ns for e in trace)
    inside = {r.request for r in records
              if r.parent == -1 and t0 <= r.start_ns and r.end_ns <= t1}
    out: Dict[int, Request] = {}
    for i, r in enumerate(records):
        if r.request in inside:
            out.setdefault(r.request, []).append((i, r))
    return out


def requests(ctx) -> Dict[int, Request]:
    return in_window(recorded(), ctx.trace)


def median_ms(reqs: Dict[int, Request],
              per_request: Callable[[Request], Optional[float]]) -> Optional[float]:
    """The median over requests of ``per_request`` (ns; None where the
    request has nothing to read), in ms."""
    values = [v for v in map(per_request, reqs.values()) if v is not None]
    return statistics.median(values) / 1e6 if values else None


def summed_ns(req: Request, match: Callable[[str], bool]) -> Optional[int]:
    """The summed durations of the request's spans whose name ``match``
    accepts; None where it has none."""
    found = [r.end_ns - r.start_ns for _, r in req if match(r.name)]
    return sum(found) if found else None


def union_ns(intervals) -> int:
    """Nanoseconds covered by at least one (start, end) interval."""
    return kineto.busy_ns([kineto.Event("", a, b, True) for a, b in intervals])


def self_ns(req: Request, name: str, children) -> Optional[int]:
    """The duration of the request's span ``name`` less the part of it
    its child spans named in ``children`` cover (each clipped to it)."""
    for i, r in req:
        if r.name == name:
            kids = [(max(c.start_ns, r.start_ns), min(c.end_ns, r.end_ns))
                    for _, c in req if c.parent == i and c.name in children]
            return r.end_ns - r.start_ns - union_ns((a, b) for a, b in kids if b > a)
    return None


def busy_intervals(trace) -> List[Tuple[int, int]]:
    """The disjoint, sorted intervals in which some device event ran."""
    merged: List[List[int]] = []
    for e in sorted((e for e in trace if e.device), key=lambda e: e.start_ns):
        if merged and e.start_ns <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e.end_ns)
        else:
            merged.append([e.start_ns, e.end_ns])
    return [(a, b) for a, b in merged]


def idle_ns(busy: List[Tuple[int, int]], ends: List[int], start: int, end: int) -> int:
    """Nanoseconds of [start, end] in which no device event ran, from the
    busy intervals (``ends`` their ends) clipped to it."""
    clipped, i = [], bisect.bisect_right(ends, start)
    while i < len(busy) and busy[i][0] < end:
        clipped.append((max(busy[i][0], start), min(busy[i][1], end)))
        i += 1
    return end - start - union_ns(clipped)


def idle_in_ms(ctx, name: str) -> Optional[float]:
    """The median over traced requests of the device's idle time inside
    their spans ``name``, in ms."""
    reqs = requests(ctx)
    if not reqs:
        return None
    busy = busy_intervals(ctx.trace)
    ends = [b for _, b in busy]

    def idle(req):
        found = [idle_ns(busy, ends, r.start_ns, r.end_ns) for _, r in req if r.name == name]
        return sum(found) if found else None

    return median_ms(reqs, idle)


def device_ms(ctx, name: str) -> Optional[float]:
    """The CUDA-event ms of the spans ``name`` per traced request that
    recorded one."""
    totals = []
    for req in requests(ctx).values():
        found = [r.device_ms for _, r in req if r.name == name and r.device_ms is not None]
        if found:
            totals.append(sum(found))
    return sum(totals) / len(totals) if totals else None
