"""Kernel time a step of the device sampler, from the ``sample`` mark to the
``fetch`` mark, over the traced epochs, in ms (``marks.py``)."""
from ..marks import phase_ms


def read(ctx):
    return phase_ms(ctx, "sample")
