"""Share of the traced epochs' wall span in which no CUDA kernel ran."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
