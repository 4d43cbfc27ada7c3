"""Summed CUDA kernel time of the traced epochs a step, in ms."""


def read(ctx):
    return 1e3 * ctx.trace.kernel_seconds() / ctx.steps if ctx.steps else None
