"""pose_ransac_ms: the median over the traced requests of the time in the
program's ``pose.ransac`` span (``ransac_eight_point``: the 256 minimal
solves, their scores and the refinement rounds), in ms: its device time
where the span records one (the card replays the stage from a CUDA
graph), else its host-clock length."""

from benchmark.metrics._pose import stage_ns
from benchmark.metrics._program import median_ms, requests


def read(ctx):
    return median_ms(requests(ctx), lambda req: stage_ns(req, "pose.ransac"))
