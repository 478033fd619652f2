"""entry_self_ms: the median over the traced requests of ``run_pair``'s
span less its stage spans (pose, rectify, disparity, recon): the entry's
own work, measured inside the program (``entry_other_ms`` measures it
from the outside, with the benchmark's own work a request), in ms."""

from benchmark.metrics._program import median_ms, requests, self_ns

STAGES = ("pose", "rectify", "disparity", "recon")


def read(ctx):
    return median_ms(requests(ctx), lambda req: self_ns(req, "run_pair", STAGES))
