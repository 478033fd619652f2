"""Device time of one named kernel per traced request, against its
roofline bound."""

from benchmark import kineto


def roofline_pct(ctx, kernel_name, bound_ms):
    """100 * bound / (device ms of the kernels whose name holds
    ``kernel_name``, per traced request); None where the trace has none."""
    if not ctx.trace or not ctx.traced_requests:
        return None
    seconds = kineto.device_seconds(ctx.trace, lambda n: kernel_name in n)
    if seconds <= 0:
        return None
    return 100.0 * bound_ms / (1e3 * seconds / ctx.traced_requests)
