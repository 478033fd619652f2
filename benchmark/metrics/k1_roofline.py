"""k1_roofline: K1 (``matcher_inputs_kernel``) against its bound on the
rectified canvas (``benchmark/roofline.py``), in %."""

from benchmark.metrics._kernels import roofline_pct
from benchmark.roofline import k1_bound_ms


def read(ctx):
    return roofline_pct(ctx, "matcher_inputs_kernel", k1_bound_ms(ctx.cell.config))
