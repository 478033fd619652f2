"""pose_features_ms: the median over the traced requests of the time in
the program's ``pose.features`` span (``detect_and_describe_batch`` on the
two images; its host-clock length, or its device time where the span
records one), in ms."""

from benchmark.metrics._pose import stage_ns
from benchmark.metrics._program import median_ms, requests


def read(ctx):
    return median_ms(requests(ctx), lambda req: stage_ns(req, "pose.features"))
