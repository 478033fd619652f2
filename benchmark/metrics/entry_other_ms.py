"""entry_other_ms: the median over the window of each request's latency
less the program's stage spans (pose, rectify, disparity, recon): the
entry's own work outside its stages, such as the disparity's trip to the
host and back, in ms."""

import statistics


def read(ctx):
    if not any(ctx.window.spans):
        return None
    return 1e3 * statistics.median(lat - sum(s.values())
                                   for lat, s in zip(ctx.window.latencies, ctx.window.spans))
