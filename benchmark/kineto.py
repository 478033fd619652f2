"""Reading a ``torch.profiler`` trace from its raw Kineto events.

``events`` copies ``chip_smoke._device_events``: it walks
``prof.profiler.kineto_results.events()`` directly, where
``key_averages()`` would first build the tree of every host op (about a
minute for the pose stage's 60k launches). The rest works on plain
``Event`` tuples, so it is tested on synthetic lists.
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, NamedTuple, Sequence


class Event(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    device: bool      # ran on the card (kernel, copy, set)


def events(prof) -> List[Event]:
    """Every event of a finished profile, device and host."""
    from torch.autograd import DeviceType

    return [Event(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                  e.device_type() == DeviceType.CUDA)
            for e in prof.profiler.kineto_results.events()]


def busy_ns(evs: Sequence[Event]) -> int:
    """Nanoseconds in which at least one device event ran: the union of
    their intervals."""
    total, cur_start, cur_end = 0, None, None
    for e in sorted((e for e in evs if e.device), key=lambda e: e.start_ns):
        if cur_end is None or e.start_ns > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = e.start_ns, e.end_ns
        else:
            cur_end = max(cur_end, e.end_ns)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def idle_pct(evs: Sequence[Event], window_ns: int) -> float:
    """The share of the window, in %, in which no device event ran."""
    return 100.0 * (1.0 - busy_ns(evs) / window_ns)


def device_seconds(evs: Sequence[Event], match) -> float:
    """Device seconds of the events whose name ``match`` accepts."""
    return sum(e.end_ns - e.start_ns for e in evs if e.device and match(e.name)) / 1e9


def _gaps(evs: Sequence[Event], t0: int, t1: int):
    """(start, end) of every stretch of [t0, t1] with no device event."""
    gaps, cursor = [], t0
    for e in sorted((e for e in evs if e.device), key=lambda e: e.start_ns):
        if e.start_ns > cursor:
            gaps.append((cursor, min(e.start_ns, t1)))
        cursor = max(cursor, e.end_ns)
    if cursor < t1:
        gaps.append((cursor, t1))
    return [(a, b) for a, b in gaps if b > a]


def _host_op_at(host: List[Event], starts: List[int], t: int) -> str:
    """The innermost host op running at time t (latest started of those
    still running), or "python" where none runs."""
    import bisect

    i = bisect.bisect_right(starts, t) - 1
    best = None
    for j in range(i, max(-1, i - 64), -1):
        e = host[j]
        if e.end_ns >= t and (best is None or e.end_ns - e.start_ns < best.end_ns - best.start_ns):
            best = e
    return best.name if best is not None else "python"


def breakdown(evs: Sequence[Event], t0: int, t1: int, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time of
    the window summed by the host call running at the middle of each gap
    ("python" where the host was in none: its own work between calls),
    each as [[name, seconds], ...] with at most ``top`` entries."""
    by_op = defaultdict(int)
    for e in evs:
        if e.device:
            by_op[e.name[:200]] += e.end_ns - e.start_ns
    host = sorted((e for e in evs if not e.device and e.end_ns > e.start_ns),
                  key=lambda e: e.start_ns)
    starts = [e.start_ns for e in host]
    by_host = defaultdict(int)
    for a, b in _gaps(evs, t0, t1):
        by_host[_host_op_at(host, starts, (a + b) // 2)[:200]] += b - a

    def ranked(d):
        return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}
