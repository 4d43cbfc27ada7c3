"""Host time the Trainer's ``enqueue`` scope took an epoch over the traced
epochs (a replayed epoch's launch), in ms."""


def read(ctx):
    return 1e3 * ctx.enqueue_s / ctx.enqueue_count if ctx.enqueue_count else None
