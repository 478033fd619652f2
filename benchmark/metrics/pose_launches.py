"""pose_launches: the median over the traced requests of the number of
device events (kernels, copies, sets) that start inside the program's
``pose`` span. The stage ends in a synchronise, so every event it queued
has run by the span's end."""

import bisect
import statistics

from benchmark.metrics._program import requests


def read(ctx):
    reqs = requests(ctx)
    if not reqs:
        return None
    starts = sorted(e.start_ns for e in ctx.trace if e.device)
    counts = []
    for req in reqs.values():
        found = [bisect.bisect_left(starts, r.end_ns) - bisect.bisect_left(starts, r.start_ns)
                 for _, r in req if r.name == "pose"]
        if found:
            counts.append(sum(found))
    return statistics.median(counts) if counts else None
