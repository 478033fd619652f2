"""recon_ms: the median of ``run_pair``'s ``timings["recon"]`` over the
window, in ms (a program span)."""

from benchmark.metrics._spans import median_ms


def read(ctx):
    return median_ms(ctx, "recon")
