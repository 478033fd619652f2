"""vgg_conv_ms: device ms of the convolution kernels per traced search:
cuDNN's direct ones (names with "conv", "fprop" or "cudnn", and its
layout transposes "nchwToNhwc" / "nhwcToNchw") and its FFT ones (the
"fft2d" transforms and the complex "cf32" products, which only the FFT
convolutions launch on this path)."""

from benchmark import kineto

MARKS = ("conv", "fprop", "cudnn", "nchwToNhwc", "nhwcToNchw", "fft2d", "cf32")


def is_conv(name: str) -> bool:
    return any(m in name for m in MARKS)


def read(ctx):
    if not ctx.trace or not ctx.traced_requests:
        return None
    seconds = kineto.device_seconds(ctx.trace, is_conv)
    return 1e3 * seconds / ctx.traced_requests if seconds > 0 else None
