"""rectify_ms: the median of ``run_pair``'s ``timings["rectify"]`` over the
window, in ms (a program span)."""

from benchmark.metrics._spans import median_ms


def read(ctx):
    return median_ms(ctx, "rectify")
