"""pose_ms: the median of ``run_pair``'s ``timings["pose"]`` over the window,
in ms (a program span: SIFT x2, matching, RANSAC and BA, ending in a
synchronise)."""

from benchmark.metrics._spans import median_ms


def read(ctx):
    return median_ms(ctx, "pose")
