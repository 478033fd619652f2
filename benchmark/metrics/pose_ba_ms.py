"""pose_ba_ms: the median over the traced requests of the time in the
program's ``pose.ba`` spans (triangulation, the outlier filter,
``bundle_adjust``'s rounds and both reprojection errors), in ms: each
span's device time where it records one (the card replays the stage from
CUDA graphs), else its host-clock length."""

from benchmark.metrics._pose import stage_ns
from benchmark.metrics._program import median_ms, requests


def read(ctx):
    return median_ms(requests(ctx), lambda req: stage_ns(req, "pose.ba"))
