"""Kernel time a step of the learning-rate schedule and Adam, from the
``optimizer`` mark to the ``accumulate`` mark, over the traced epochs, in ms
(``marks.py``)."""
from ..marks import phase_ms


def read(ctx):
    return phase_ms(ctx, "optimizer")
