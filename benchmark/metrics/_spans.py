"""Medians of the program's own stage timings (``run_pair``'s
``timings``: host clock around work that ends in a device synchronise)."""

import statistics


def median_ms(ctx, stage):
    """The median of ``stage`` over the window's requests, in ms; None
    where the program reported no such span."""
    values = [s[stage] for s in ctx.window.spans if stage in s]
    return 1e3 * statistics.median(values) if values else None
