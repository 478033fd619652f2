"""lpips_distance_ms: device ms of the program's ``perceptual.distance``
spans (each row block's channel normalisation, lin-weighted sums, Gram
band, gather and write into the volume, between CUDA events) per traced
search."""

from benchmark.metrics._program import device_ms


def read(ctx):
    return device_ms(ctx, "perceptual.distance")
