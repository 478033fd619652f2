"""vgg_tower_ms: device ms of the program's ``perceptual.tower`` spans (each
row block's crops and VGG-16 forwards, between CUDA events) per traced
search."""

from benchmark.metrics._program import device_ms


def read(ctx):
    return device_ms(ctx, "perceptual.tower")
