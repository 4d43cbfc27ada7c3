"""NCCL all-reduce kernel time a step on rank 0, in ms (the time it waits for
the slowest rank included)."""


def read(ctx):
    t = ctx.trace.kernel_seconds("AllReduce")
    return 1e3 * t / ctx.steps if t and ctx.steps else None
