"""Plain reference of ``ssd_750x900_d200``: ``pair(left, right, K, F,
pipeline, device, low=False)`` is the calibrated SSD chain of
``benchmark/reference/stereo.py`` (rectification by F, the block search
with its smoothing recurrence, the back-warp, the outlier clamp, depth)."""

from benchmark.reference.stereo import ssd_pair as pair  # noqa: F401
