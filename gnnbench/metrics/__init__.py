"""Per-layer metrics, one file a metric, found by the metric's name in
``BENCHMARK.json``.  Each has ``read(ctx)``, ``ctx`` a :class:`Readings`, and
returns the number, or ``None`` when the run holds nothing to read (the
metric is then left out of the line; a share of a peak is never 0 for
want of data)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Readings:
    """What a traced run read: the trace of the traced epochs (rank 0's in a
    data-parallel cell), their epochs and optimizer steps, the model FLOPs
    and the least ``take_rows`` bytes of those steps (the benchmark's own
    counts), and the Trainer's phase timers (``enqueue`` over the traced
    epochs; ``capture`` over the whole run)."""

    trace: object
    epochs: int
    steps: int
    flops: float
    take_rows_bytes: Optional[float]
    enqueue_s: float
    enqueue_count: int
    capture_s: Optional[float]
