"""Kernel time a step of the layer-0 fetch (``take_rows``), from the ``fetch``
mark to the ``forward`` mark, over the traced epochs, in ms (``marks.py``)."""
from ..marks import phase_ms


def read(ctx):
    return phase_ms(ctx, "fetch")
