"""Plain reference of ``perceptual_375x450_d100``
(``benchmark/reference/lpips.py``): ``cost_volume`` (the seeded weights,
the per-window tower, the LPIPS costs), ``table_for`` (cell 8's weights),
``smooth`` (cell 10's chunked smoothing), and
``forced_excess``, which judges a disparity map against the costs."""

from benchmark.reference.lpips import (  # noqa: F401
    cost_volume, forced_excess, smooth, table_for)
