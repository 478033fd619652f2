"""mfu: the whole request's share of the card's float32 peak, in %: the
matcher's operations on one pair (``roofline.ssd_pair_flops``) over the
window's mean time a pair (host clock) and 67 TFLOP/s."""

from benchmark.roofline import PEAK_FP32, ssd_pair_flops


def read(ctx):
    per_pair_s = ctx.window.seconds / (ctx.window.requests * ctx.pairs_per_request)
    return 100.0 * ssd_pair_flops(ctx.cell.config) / (per_pair_s * PEAK_FP32)
