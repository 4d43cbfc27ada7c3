"""Device idle time from one traced epoch's ``epoch_end`` mark to the next
one's ``epoch`` mark, averaged over those boundaries, in ms (``marks.py``):
the host's turn between epochs, the part of ``device_idle_pct`` that is not
a gap inside an epoch's graph."""
from ..marks import epoch_gap_ms


def read(ctx):
    return epoch_gap_ms(ctx)
