"""dense_ms: the median over the traced requests of the time in the
program's ``dense`` spans (``run_batch``: the warps, the matcher, the
back-warp, the clamp and depth queued, through the downloads that wait
for them; host clock), in ms."""

from benchmark.metrics._program import median_ms, requests, summed_ns


def read(ctx):
    return median_ms(requests(ctx), lambda req: summed_ns(req, lambda name: name == "dense"))
