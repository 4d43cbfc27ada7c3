"""Kernel time a step of the backward pass, from the ``backward`` mark to the
``sync`` mark or, without one, the ``optimizer`` mark, over the traced
epochs, in ms (``marks.py``); the all-reduce after ``sync`` is
``allreduce_ms_per_step``'s."""
from ..marks import phase_ms


def read(ctx):
    return phase_ms(ctx, "backward")
