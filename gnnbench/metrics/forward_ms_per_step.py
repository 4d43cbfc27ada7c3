"""Kernel time a step of the model forward and the loss, from the ``forward``
mark to the ``backward`` mark, over the traced epochs, in ms (``marks.py``)."""
from ..marks import phase_ms


def read(ctx):
    return phase_ms(ctx, "forward")
