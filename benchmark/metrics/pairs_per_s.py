"""pairs_per_s: pairs completed in the window over the window's time
(host clock, from the first call to the last result)."""


def read(ctx):
    return ctx.window.requests * ctx.pairs_per_request / ctx.window.seconds
