"""rectify_host_ms: the median over the traced requests of the program's
``rectify.homographies`` span (host Loop-Zhang in float64 and the
canvas), in ms."""

from benchmark.metrics._program import median_ms, requests, summed_ns


def read(ctx):
    return median_ms(requests(ctx), lambda req: summed_ns(
        req, lambda name: name == "rectify.homographies"))
