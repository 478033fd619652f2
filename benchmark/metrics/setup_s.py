"""setup_s: process start to the end of the warm-up request (imports,
CUDA, the inputs from the seed, the kernel library, one request)."""


def read(ctx):
    return ctx.setup_s
