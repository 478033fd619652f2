"""copy_ms: the median over the traced requests of the program's copy
spans summed (``*.upload``: host to card, ``*.download``: card to
host), in ms."""

from benchmark.metrics._program import median_ms, requests, summed_ns


def read(ctx):
    return median_ms(requests(ctx), lambda req: summed_ns(
        req, lambda name: name.endswith((".upload", ".download"))))
