"""latency_p95_ms: the 95th percentile of every request's time in the
window, from the call to the returned result (host clock)."""

from benchmark.harness import p95


def read(ctx):
    return 1e3 * p95(ctx.window.latencies)
