"""perceptual_mfu: the whole search's share of the card's float32 peak,
in %: the VGG-16 convolutions' and the Gram band's operations of one
search (``roofline.perceptual_search_flops``) over the window's mean time
a search (host clock) and 67 TFLOP/s."""

from benchmark.roofline import PEAK_FP32, perceptual_search_flops


def read(ctx):
    per_search_s = ctx.window.seconds / ctx.window.requests
    return 100.0 * perceptual_search_flops(ctx.cell.config) / (per_search_s * PEAK_FP32)
