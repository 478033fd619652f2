"""k1b_roofline: K1b (``row_scan_kernel``) against its bound on the
rectified canvas (``benchmark/roofline.py``), in %."""

from benchmark.metrics._kernels import roofline_pct
from benchmark.roofline import k1b_bound_ms


def read(ctx):
    return roofline_pct(ctx, "row_scan_kernel", k1b_bound_ms(ctx.cell.config))
