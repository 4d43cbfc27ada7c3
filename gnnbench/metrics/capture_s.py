"""Host time of the Trainer's ``capture`` scope (CUDA graph capture), in s."""


def read(ctx):
    return ctx.capture_s or None
