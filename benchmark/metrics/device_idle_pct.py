"""device_idle_pct: the share of the traced requests' wall time in which
no operation ran on the card, in % (the union of the trace's device
events; ``.posed``, ``.fixedF`` and ``.perceptual`` read the same)."""

from benchmark import kineto


def read(ctx):
    if not ctx.trace:
        return None
    return kineto.idle_pct(ctx.trace, int(ctx.traced_seconds * 1e9))
